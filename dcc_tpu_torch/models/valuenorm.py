"""Value normalizer: running mean / mean-square with debiasing.

Counterpart of :mod:`dcc_tpu.models.valuenorm` (beta 0.99999, variance
clamped at 1e-2, debias clamped at eps). The state is an immutable tuple of
tensors threaded through the update, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import resolve_device


class ValueNormState(NamedTuple):
    mean: torch.Tensor  # (1,)
    mean_sq: torch.Tensor  # (1,)
    debias: torch.Tensor  # ()
    beta: torch.Tensor  # () f32, so 1 - beta rounds as in the JAX package
    epsilon: torch.Tensor  # () f32


def init(device=None, beta: float = 0.99999, epsilon: float = 1e-5) -> ValueNormState:
    """Zero state on ``device``: CUDA unless the caller asks for the CPU."""
    device = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return ValueNormState(z(1), z(1), z(), c(beta), c(epsilon))


def stats(st: ValueNormState):
    """Debiased (mean, var)."""
    debias = torch.clamp(st.debias, min=st.epsilon)
    mean = st.mean / debias
    mean_sq = st.mean_sq / debias
    return mean, torch.clamp(mean_sq - mean**2, min=1e-2)


def update(st: ValueNormState, batch: torch.Tensor) -> ValueNormState:
    """batch (..., 1): mean over all leading axes."""
    flat = batch.reshape(-1, batch.shape[-1]).to(st.mean.dtype)
    w = st.beta
    return st._replace(
        mean=st.mean * w + flat.mean(dim=0) * (1.0 - w),
        mean_sq=st.mean_sq * w + (flat**2).mean(dim=0) * (1.0 - w),
        debias=st.debias * w + (1.0 - w),
    )


def normalize(st: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = stats(st)
    return ((x - mean) / torch.sqrt(var)).to(x.dtype)


def denormalize(st: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = stats(st)
    return (x * torch.sqrt(var) + mean).to(x.dtype)
