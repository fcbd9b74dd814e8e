"""Masked multi-layer GRU followed by a LayerNorm (the recurrent policy path).

Counterpart of :class:`dcc_tpu.models.rnn.MaskedGRU`: ``recurrent_n``
stacked flax-style GRU cells whose hidden state is multiplied by the step
mask before every step (zero at an episode start), then LayerNorm ``norm``
(eps 1e-6, fast variance) on the top cell's output.

The cell is flax's ``GRUCell``, not ``torch.nn.GRUCell``: six Dense layers
``ir, iz, in`` with bias and ``hr, hz`` without, ``hn`` with bias,

    r = sigmoid(W_ir x + b_ir + W_hr h)
    z = sigmoid(W_iz x + b_iz + W_hz h)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

torch's cell has two more trainable biases (b_hr, b_hz), which Adam would
move. Submodules are named ``gru{i}.{ir,iz,in,hr,hz,hn}`` and ``norm``, as
the flax tree, so :mod:`dcc_tpu_torch.compat.flax_params` converts the
weights both ways unchanged. The GRU and its LN run in f32 in both compute
modes (flax's ``Dense(dtype=None)`` promotes a bf16 trunk output to f32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.fused_mlp import ln_stats
from .mlp import LNParams

_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


class GRUCell(nn.Module):
    def __init__(self, hidden_size: int, use_orthogonal: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in _GATES:
            layer = nn.Linear(hidden_size, hidden_size, bias=name not in ("hr", "hz"))
            if use_orthogonal:
                nn.init.orthogonal_(layer.weight, generator=generator)
            else:
                nn.init.xavier_uniform_(layer.weight, generator=generator)
            if layer.bias is not None:
                nn.init.zeros_(layer.bias)
            # "in" is a Python keyword, hence setattr / getattr
            setattr(self, name, layer)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x (B, H) f32 or bf16, h (B, H) f32 -> new h (B, H) f32. Each input
        gate casts a bf16 ``x`` to f32 on its own, as each flax Dense
        promotes its input: the cotangent of ``x`` is then the bf16 sum of
        three bf16-rounded terms, as in the JAX package."""
        ir, iz, in_, hr, hz, hn = (getattr(self, name) for name in _GATES)
        r = torch.sigmoid(ir(x.float()) + hr(h))
        z = torch.sigmoid(iz(x.float()) + hz(h))
        n = torch.tanh(in_(x.float()) + r * hn(h))
        return (1.0 - z) * n + z * h


class MaskedGRU(nn.Module):
    def __init__(self, hidden_size: int = 256, recurrent_n: int = 1,
                 use_orthogonal: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.recurrent_n = recurrent_n
        for i in range(recurrent_n):
            setattr(self, f"gru{i}", GRUCell(hidden_size, use_orthogonal, generator))
        self.norm = LNParams(hidden_size)

    def _cell_step(self, x, h, mask):
        """x (B, H), h (B, L, H), mask (B, 1) -> (top output, new h)."""
        hs = []
        out = x
        for i in range(self.recurrent_n):
            out = getattr(self, f"gru{i}")(out, h[:, i] * mask)
            hs.append(out)
        return out, torch.stack(hs, dim=1)

    def _norm(self, x):
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mu, inv = ln_stats(x)
        return (x - mu) * (inv * self.norm.weight) + self.norm.bias

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One rollout step: x (B, H), h (B, L, H), masks (B, 1) -> (normed
        output (B, H) f32, new hidden (B, L, H))."""
        out, h = self._cell_step(x, h, masks)
        return self._norm(out), h

    def sequence(self, xs: torch.Tensor, h0: torch.Tensor,
                 masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training-time sequence: xs (T, B, H), h0 (B, L, H), masks
        (T, B, 1) -> (normed outputs (T, B, H) f32, final hidden). The mask
        reset at every step subsumes the reference's done-boundary
        chunking."""
        h, outs = h0, []
        for t in range(xs.shape[0]):
            out, h = self._cell_step(xs[t], h, masks[t])
            outs.append(out)
        return self._norm(torch.stack(outs)), h
