"""MLP trunk: LayerNorm(obs) -> [Linear -> act -> LayerNorm] x (1 + layer_n).

Counterpart of :class:`dcc_tpu.models.mlp.MLPBase`: orthogonal init with the
activation's gain, zero biases, LayerNorm with eps 1e-6 and the fast
variance (not ``nn.LayerNorm``'s 1e-5). Parameters stay f32; ``bf16=True``
runs the JAX package's mixed-precision rounding points. With ``fused=True``
the forward runs as the K2 kernel on CUDA tensors
(:func:`dcc_tpu_torch.ops.fused_mlp.fused_mlp`); otherwise it is the plain
PyTorch chain, which autograd differentiates.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.fused_mlp import fused_mlp, pack_params, trunk_forward_plain

RELU_GAIN = 2.0 ** 0.5
TANH_GAIN = 5.0 / 3.0


class LNParams(nn.Module):
    """Parameter shell of a LayerNorm (scale ``weight``, ``bias``); the
    normalization itself runs inside the trunk chain."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def init_linear(layer: nn.Linear, gain: float, orthogonal: bool,
                generator: Optional[torch.Generator]) -> None:
    if orthogonal:
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
    else:
        nn.init.xavier_uniform_(layer.weight, generator=generator)
    nn.init.zeros_(layer.bias)


class MLPBase(nn.Module):
    def __init__(
        self,
        in_dim: int,
        hidden_size: int = 256,
        layer_n: int = 1,
        use_relu: bool = True,
        use_feature_normalization: bool = True,
        use_orthogonal: bool = True,
        bf16: bool = False,
        fused: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_layers = 1 + layer_n
        self.use_relu = use_relu
        self.use_fn = use_feature_normalization
        self.bf16 = bf16
        self.fused = fused
        self._packed = None  # (key, pack_params output) of the K2 launches
        if self.use_fn:
            self.feature_norm = LNParams(in_dim)
        gain = RELU_GAIN if use_relu else TANH_GAIN
        d = in_dim
        for i in range(self.n_layers):
            fc = nn.Linear(d, hidden_size)
            init_linear(fc, gain, use_orthogonal, generator)
            setattr(self, f"fc{i}", fc)
            setattr(self, f"norm{i}", LNParams(hidden_size))
            d = hidden_size

    def flat_params(self) -> List[torch.Tensor]:
        """The kernels' flat list: [fn_scale, fn_bias]? + [W (in, out), b,
        ln_scale, ln_bias] * L."""
        flat = []
        if self.use_fn:
            flat += [self.feature_norm.weight, self.feature_norm.bias]
        for i in range(self.n_layers):
            fc, ln = getattr(self, f"fc{i}"), getattr(self, f"norm{i}")
            flat += [fc.weight.t(), fc.bias, ln.weight, ln.bias]
        return flat

    def packed_params(self, device) -> tuple:
        """:func:`flat_params` packed for the K2 kernel, packed again only
        when a parameter changed: the key holds each parameter's address and
        in-place version counter, which an optimizer step, ``load_state_dict``
        or a copy changes."""
        flat = self.flat_params()
        key = (str(device),) + tuple((p.data_ptr(), p._version) for p in flat)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_params(flat, device))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kw = dict(n_layers=self.n_layers, use_relu=self.use_relu, bf16=self.bf16)
        if self.fused:
            packed = self.packed_params(x.device) if x.is_cuda else None
            return fused_mlp(x, self.flat_params(), use_feature_norm=self.use_fn,
                             packed=packed, **kw)
        lead = x.shape[:-1]
        out = trunk_forward_plain(
            x.reshape(-1, x.shape[-1]), self.flat_params(), use_fn=self.use_fn, **kw
        )
        return out.reshape(*lead, out.shape[-1])
