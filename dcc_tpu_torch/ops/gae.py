"""Generalized Advantage Estimation as a reverse-time loop.

Counterpart of :mod:`dcc_tpu.ops.gae` (the ``lax.scan`` formulation):

    delta_t = r_t + gamma * V(s_{t+1}) * mask_{t+1} - V(s_t)
    gae_t   = delta_t + gamma * lambda * mask_{t+1} * gae_{t+1}
    ret_t   = gae_t + V(s_t)

with the ``use_proper_time_limits`` bad-mask variant and the
``use_gae=False`` discounted-return path. Values are denormalized by the
caller. The kernel version of the plain recurrence is
:func:`dcc_tpu_torch.ops.cuda_gae.compute_gae_cuda`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, ..., 1)
    values: torch.Tensor,  # (T+1, ..., 1) denormalized
    masks: torch.Tensor,  # (T+1, ..., 1)
    gamma: float,
    gae_lambda: float,
    bad_masks: Optional[torch.Tensor] = None,  # (T+1, ..., 1)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each (T, ...)."""
    v_next, v_curr, m_next = values[1:], values[:-1], masks[1:]
    gae = torch.zeros_like(rewards[0] + v_curr[0] * m_next[0])
    out = []
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * v_next[t] * m_next[t] - v_curr[t]
        gae = delta + gamma * gae_lambda * m_next[t] * gae
        if bad_masks is not None:
            gae = gae * bad_masks[t + 1]
        out.append(gae)
    adv = torch.stack(out[::-1])
    return adv, adv + v_curr


def discounted_returns(
    rewards: torch.Tensor,
    next_value: torch.Tensor,
    masks: torch.Tensor,
    gamma: float,
    bad_masks: Optional[torch.Tensor] = None,
    values: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``use_gae=False``: ret_t = r_t + gamma * mask_{t+1} * ret_{t+1}; with
    bad_masks a truncated step's return falls back to V(s_t)."""
    if bad_masks is not None and values is None:
        raise ValueError("values required when bad_masks is given")
    ret = next_value
    out = []
    for t in reversed(range(rewards.shape[0])):
        if bad_masks is None:
            ret = rewards[t] + gamma * masks[t + 1] * ret
        else:
            bm = bad_masks[t + 1]
            ret = bm * (gamma * masks[t + 1] * ret + rewards[t]) + (1.0 - bm) * values[t]
        out.append(ret)
    return torch.stack(out[::-1])
