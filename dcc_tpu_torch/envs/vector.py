"""Batched vector environment with in-step auto-reset.

Counterpart of :mod:`dcc_tpu.envs.vector`: E envs step in lock-step; an env
whose episode ended (real done or time-limit truncation) is reset inside the
step and returns the *reset* observation together with the pre-reset
reward / done / coverage rate, as the reference's worker protocol does.
"""

from __future__ import annotations

import torch

from .coverage import EnvConfig, EnvState, StepOut, observation, reset, step


def reset_batch(
    cfg: EnvConfig, n_envs: int, dtype: torch.dtype = torch.float32, device=None
) -> EnvState:
    """Reset E envs (the default reset is deterministic, so no generator) on
    ``device``: CUDA unless the caller asks for the CPU."""
    return reset(cfg, n_envs, dtype=dtype, device=device)


def step_batch(cfg: EnvConfig, states: EnvState, actions: torch.Tensor):
    """Step E envs with (E, N, 2) actions; auto-reset finished envs."""
    new_states, out = step(cfg, states, actions)
    boundary = out.done | out.truncated
    fresh = reset(
        cfg, states.pos.shape[0], dtype=states.pos.dtype, device=states.pos.device
    )
    selected = new_states.select(boundary, fresh)
    # for envs that did not reset, observation(selected) is out.obs exactly
    obs = observation(cfg, selected)
    return selected, StepOut(
        obs=obs,
        reward=out.reward,
        done=out.done,
        coverage_rate=out.coverage_rate,
        truncated=out.truncated,
    )


def share_obs_from_obs(obs: torch.Tensor) -> torch.Tensor:
    """Centralized-critic observation: (..., N, D) -> (..., N, N*D), the
    concat of all agents' obs replicated per agent."""
    *lead, n, d = obs.shape
    return obs.reshape(*lead, 1, n * d).expand(*lead, n, n * d)
