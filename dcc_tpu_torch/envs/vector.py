"""Batched vector environment with in-step auto-reset.

Counterpart of :mod:`dcc_tpu.envs.vector`: E envs step in lock-step; an env
whose episode ended (real done or time-limit truncation) is reset inside the
step and returns the *reset* observation together with the pre-reset
reward / done / coverage rate, as the reference's worker protocol does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .coverage import EnvConfig, EnvState, StepOut, observation, reset, step


def reset_batch(
    cfg: EnvConfig, n_envs: int, dtype: torch.dtype = torch.float32, device=None,
    generator: Optional[torch.Generator] = None,
) -> EnvState:
    """Reset E envs on ``device``: CUDA unless the caller asks for the CPU.
    The default reset is deterministic and takes no generator; with
    ``randomize_pois`` or ``poi_speed`` the draws come from ``generator``."""
    return reset(cfg, n_envs, dtype=dtype, device=device, generator=generator)


def step_batch(cfg: EnvConfig, states: EnvState, actions: torch.Tensor,
               generator: Optional[torch.Generator] = None):
    """Step E envs with (E, N, ``action_width``) actions; auto-reset finished
    envs. A random reset draws a fresh layout for all E envs from
    ``generator`` every step and keeps it where an episode ended, so the
    host never waits for the done mask."""
    new_states, out = step(cfg, states, actions)
    boundary = out.done | out.truncated
    fresh = reset(
        cfg, states.pos.shape[0], dtype=states.pos.dtype, device=states.pos.device,
        generator=generator,
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
