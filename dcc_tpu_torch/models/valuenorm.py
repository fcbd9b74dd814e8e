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


def batch_moments(batch: torch.Tensor, dtype: torch.dtype, allsum=None, n=None):
    """(mean, mean of squares) of ``batch`` (..., out) over all leading
    axes, each (out,): the sums over this process's rows, summed over the
    ranks by ``allsum`` (a mesh's; None in one process), over ``n`` rows in
    all (default this process's)."""
    flat = batch.reshape(-1, batch.shape[-1]).to(dtype)
    s = torch.stack([flat.sum(dim=0), (flat**2).sum(dim=0)])
    if allsum is not None:
        s = allsum(s)
    s = s / (flat.shape[0] if n is None else n)
    return s[0], s[1]


def update(st: ValueNormState, batch: torch.Tensor, allsum=None, n=None) -> ValueNormState:
    """batch (..., 1): mean over all leading axes (over the ranks with
    ``allsum`` and ``n``, :func:`batch_moments`)."""
    mean, mean_sq = batch_moments(batch, st.mean.dtype, allsum, n)
    w = st.beta
    return st._replace(
        mean=st.mean * w + mean * (1.0 - w),
        mean_sq=st.mean_sq * w + mean_sq * (1.0 - w),
        debias=st.debias * w + (1.0 - w),
    )


def normalize(st: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = stats(st)
    return ((x - mean) / torch.sqrt(var)).to(x.dtype)


def denormalize(st: ValueNormState, x: torch.Tensor) -> torch.Tensor:
    mean, var = stats(st)
    return (x * torch.sqrt(var) + mean).to(x.dtype)
