"""Diagonal-Gaussian action distribution with a state-independent log-std
(the ``normal_*`` functions of :mod:`dcc_tpu.models.distributions`)."""

from __future__ import annotations

import math
from typing import Optional

import torch

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def normal_sample(
    mean: torch.Tensor, log_std: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    noise = torch.randn(
        mean.shape, generator=generator, dtype=mean.dtype, device=mean.device
    )
    return mean + torch.exp(log_std) * noise


def normal_log_prob(mean, log_std, action) -> torch.Tensor:
    """Sum over action dims, keepdim (the reference's FixedNormal.log_probs)."""
    var = torch.exp(2.0 * log_std)
    lp = -((action - mean) ** 2) / (2.0 * var) - log_std - LOG_SQRT_2PI
    return torch.sum(lp, dim=-1, keepdim=True)


def normal_entropy(log_std, mean) -> torch.Tensor:
    """Per-dim entropy broadcast to mean's shape, not summed."""
    return (0.5 + LOG_SQRT_2PI + log_std).expand_as(mean)


def normal_mode(mean: torch.Tensor) -> torch.Tensor:
    return mean
