"""Batched vector environment with in-step auto-reset.

Counterpart of :mod:`dcc_tpu.envs.vector`: E envs step in lock-step; an env
whose episode ended (real done or time-limit truncation) is reset inside the
step and returns the *reset* observation together with the pre-reset
reward / done / coverage rate, as the reference's worker protocol does.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .coverage import EnvConfig, EnvState, observation, reset, step


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
    return _auto_reset_step(step, reset, observation, cfg, states, actions, generator)


def _auto_reset_step(step_fn, reset_fn, obs_fn, cfg, states, actions, generator):
    """One batched step of a scenario's functions, each env that ended (done
    or truncated) replaced by a fresh reset; the observation is the reset
    one there, the reward, done and coverage those of the step."""
    new_states, out = step_fn(cfg, states, actions)
    boundary = out.done | out.truncated
    fresh = reset_fn(cfg, states.pos.shape[0], dtype=states.pos.dtype,
                     device=states.pos.device, generator=generator)
    selected = new_states.select(boundary, fresh)
    # for envs that did not reset, obs_fn(selected) is out.obs exactly
    return selected, out._replace(obs=obs_fn(cfg, selected))


def share_obs_from_obs(obs: torch.Tensor) -> torch.Tensor:
    """Centralized-critic observation: (..., N, D) -> (..., N, N*D), the
    concat of all agents' obs replicated per agent."""
    *lead, n, d = obs.shape
    return obs.reshape(*lead, 1, n * d).expand(*lead, n, n * d)


def make_vec_fns(scenario: str = "coverage", reset=None):
    """(reset_batch, step_batch) of a registered scenario, with the
    signatures and auto-reset of the coverage pair above (its own pair for
    coverage): ``reset_batch(cfg, n_envs, dtype=, device=, generator=)``
    and ``step_batch(cfg, states, actions, generator)``, which resets an
    env on done or on truncation, from a fresh layout for all E envs drawn
    from ``generator`` every step (counterpart of
    ``dcc_tpu.envs.vector.make_vec_fns``). ``reset`` (the same signature)
    replaces the scenario's reset in both (a rank's share of the envs,
    :func:`dcc_tpu_torch.parallel.mesh.sharded_reset`)."""
    if scenario == "coverage" and reset is None:
        return reset_batch, step_batch
    from . import get_scenario

    sc = get_scenario(scenario)
    reset = sc["reset"] if reset is None else reset
    return reset, functools.partial(_auto_reset_step, sc["step"], reset, sc["observation"])
