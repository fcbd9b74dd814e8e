"""rlkit-style MLP, the network family of MADDPG, with its members stacked.

Counterpart of :mod:`dcc_tpu.models.rlkit_mlp`: GELU hidden layers (flax's
``nn.gelu``, the tanh approximation), hidden kernels U(+-1/sqrt(fan_in))
with biases 0.1, the last layer's kernel and bias U(+-init_w), an optional
tanh output and ``return_pre``.

Where the JAX package ``vmap``s one network over a leading agent axis of
its parameters, :class:`RlkitMlp` holds ``n_stack`` networks at once: each
Dense has a kernel (S, in, out), flax's (in, out) orientation, and a bias
(S, out), and is applied to (S, B, in) inputs as one batched product
(``torch.baddbmm``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.rand(shape, generator=generator) * (2.0 * bound) - bound


class StackedDense(nn.Module):
    """S Dense layers: ``x @ kernel[s] + bias[s]`` for each member s."""

    def __init__(self, n_stack: int, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_stack, d_in, d_out))
        self.bias = nn.Parameter(torch.empty(n_stack, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, B, in) -> (S, B, out)."""
        return torch.baddbmm(self.bias.unsqueeze(1), x, self.kernel)


class RlkitMlp(nn.Module):
    def __init__(self, input_size: int, output_size: int, hidden_sizes: Sequence[int] = (64,),
                 n_stack: int = 1, init_w: float = 3e-3, b_init_value: float = 0.1,
                 tanh_output: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_sizes = tuple(hidden_sizes)
        self.tanh_output = tanh_output
        d = input_size
        with torch.no_grad():
            for i, h in enumerate(self.hidden_sizes):
                fc = StackedDense(n_stack, d, h)
                fc.kernel.copy_(_uniform(fc.kernel.shape, d ** -0.5, generator))
                fc.bias.fill_(b_init_value)
                setattr(self, f"fc{i}", fc)
                d = h
            self.last_fc = StackedDense(n_stack, d, output_size)
            self.last_fc.kernel.copy_(_uniform(self.last_fc.kernel.shape, init_w, generator))
            self.last_fc.bias.copy_(_uniform(self.last_fc.bias.shape, init_w, generator))

    def forward(self, x: torch.Tensor, return_pre: bool = False):
        """x (S, B, in) -> (S, B, out); with ``return_pre`` also the output
        before the tanh (the actor loss regularizes it)."""
        for i in range(len(self.hidden_sizes)):
            x = F.gelu(getattr(self, f"fc{i}")(x), approximate="tanh")
        pre = self.last_fc(x)
        out = torch.tanh(pre) if self.tanh_output else pre
        return (out, pre) if return_pre else out
