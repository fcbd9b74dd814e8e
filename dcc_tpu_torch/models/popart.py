"""PopArt value-head normalizer (off by default, ``use_popart: false``).

Counterpart of :mod:`dcc_tpu.models.popart`: running output statistics
(beta 0.99999) that rescale the value head's weight and bias whenever they
move, so that the head's unnormalized outputs are preserved. The state is an
immutable tuple of tensors threaded through the update, as the value
normalizer's; :func:`update` returns the rescaled head for the caller to
write into the network.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import resolve_device
from .valuenorm import batch_moments


class PopArtState(NamedTuple):
    mean: torch.Tensor  # (out,)
    mean_sq: torch.Tensor  # (out,)
    debias: torch.Tensor  # ()
    stddev: torch.Tensor  # (out,)
    beta: torch.Tensor  # () f32, so 1 - beta rounds as in the JAX package
    epsilon: torch.Tensor  # () f32


def init(out_shape: int = 1, device=None, beta: float = 0.99999) -> PopArtState:
    """Zero statistics and unit stddev on ``device``: CUDA unless the caller
    asks for the CPU."""
    device = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return PopArtState(z(out_shape), z(out_shape), z(), torch.ones(out_shape, device=device),
                       c(beta), c(1e-5))


def update(st: PopArtState, kernel: torch.Tensor, bias: torch.Tensor, batch: torch.Tensor,
           allsum=None, n=None):
    """EMA-update the statistics on ``batch`` (..., out) and rescale the head
    (new std from the raw EMA statistics, clamped at 1e-4; kernel *=
    old_std / new_std; bias = (old_std * bias + old_mean - new_mean) /
    new_std); over the ranks with ``allsum`` and ``n``
    (:func:`~dcc_tpu_torch.models.valuenorm.batch_moments`). Returns
    (state, kernel, bias)."""
    old_mean, old_std = st.mean, st.stddev
    b_mean, b_mean_sq = batch_moments(batch, st.mean.dtype, allsum, n)
    w = st.beta
    mean = st.mean * w + b_mean * (1.0 - w)
    mean_sq = st.mean_sq * w + b_mean_sq * (1.0 - w)
    debias = st.debias * w + (1.0 - w)
    stddev = torch.clamp(torch.sqrt(mean_sq - mean**2), min=1e-4)
    new_kernel = kernel * (old_std / stddev)
    new_bias = (old_std * bias + old_mean - mean) / stddev
    return st._replace(mean=mean, mean_sq=mean_sq, debias=debias, stddev=stddev), \
        new_kernel, new_bias


def debiased(st: PopArtState):
    """Debiased (mean, var)."""
    debias = torch.clamp(st.debias, min=st.epsilon)
    mean = st.mean / debias
    return mean, torch.clamp(st.mean_sq / debias - mean**2, min=1e-2)


def normalize(st: PopArtState, x: torch.Tensor) -> torch.Tensor:
    mean, var = debiased(st)
    return ((x - mean) / torch.sqrt(var)).to(x.dtype)


def denormalize(st: PopArtState, x: torch.Tensor) -> torch.Tensor:
    mean, var = debiased(st)
    return (x * torch.sqrt(var) + mean).to(x.dtype)
