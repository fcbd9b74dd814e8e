"""The golden-trace harness: replay the reference environment's recorded
episodes through the port's env and diff every step.

The counterpart of :mod:`dcc_tpu.compat` (``GoldenTrace``, ``load_golden``,
``replay``, ``compare``). The traces are ``tests/golden/*.npz``: the
reference's float64 numpy physics driven by recorded random actions from its
deterministic reset (agents at the origin, PoIs from the frozen bank). Given
the same actions, the port's env in float64 must reproduce the per-step
observations, the shared team reward, the dones and the coverage rates
(``tests/test_env_parity.py``'s tolerances). The port steps one action at a
time from ``reset(cfg, 1, dtype, device)``, on the CPU or on the GPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..envs import EnvConfig, StepOut, observation, reset, step

# the repo's test data, not a module of the JAX package
DEFAULT_GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "golden",
)


@dataclass
class GoldenTrace:
    """One recorded reference episode: actions in, expected outputs."""

    cfg: EnvConfig
    actions: np.ndarray  # (T, N, 2)
    obs0: np.ndarray  # (N, obs_dim) reset observation
    obs: np.ndarray  # (T, N, obs_dim)
    rewards: np.ndarray  # (T, N): the shared team sum, the same for every agent
    dones: np.ndarray  # (T, N)
    coverage: np.ndarray  # (T,)

    @property
    def shared_reward(self) -> np.ndarray:  # (T,)
        return self.rewards[:, 0]

    @property
    def team_done(self) -> np.ndarray:  # (T,)
        return self.dones.all(axis=1)


def load_golden(name: str, golden_dir: Optional[str] = None) -> GoldenTrace:
    g = np.load(os.path.join(golden_dir or DEFAULT_GOLDEN_DIR, name + ".npz"))
    cfg = EnvConfig(
        n_agents=int(g["num_agents"]),
        n_pois=int(g["num_pois"]),
        comm_force_scale=float(g["comm_force_scale"]),
        comm_r_scale=float(g["comm_r_scale"]),
    )
    return GoldenTrace(
        cfg=cfg,
        actions=g["actions"],
        obs0=g["obs0"],
        obs=g["obs"],
        rewards=g["rewards"],
        dones=g["dones"],
        coverage=g["coverage_rate"],
    )


def replay(trace: GoldenTrace, dtype: torch.dtype = torch.float64, device=None):
    """Replay the trace's actions through the port's env on ``device``
    (CUDA unless the caller asks for the CPU): (reset obs (N, obs_dim),
    :class:`StepOut` of (T, ...) tensors, one env's)."""
    state = reset(trace.cfg, 1, dtype=dtype, device=device)
    obs0 = observation(trace.cfg, state)[0]
    actions = torch.as_tensor(trace.actions, dtype=dtype, device=state.pos.device)
    outs = []
    for a in actions:
        state, out = step(trace.cfg, state, a[None])
        outs.append(out)
    return obs0, StepOut(*(torch.cat(f) for f in zip(*outs)))


def compare(trace: GoldenTrace, dtype: torch.dtype = torch.float64,
            device=None) -> Dict[str, float]:
    """Largest absolute per-step deviation from the golden trace, per field."""
    obs0, out = replay(trace, dtype, device)
    out = StepOut(*(f.cpu() for f in out))
    return {
        "obs0": float(np.abs(obs0.cpu().double().numpy() - trace.obs0).max()),
        "obs": float(np.abs(out.obs.double().numpy() - trace.obs).max()),
        "reward": float(np.abs(out.reward.double().numpy() - trace.shared_reward).max()),
        "done": float(np.abs(out.done.double().numpy() - trace.team_done).max()),
        "coverage": float(np.abs(out.coverage_rate.double().numpy() - trace.coverage).max()),
    }


__all__ = ["DEFAULT_GOLDEN_DIR", "GoldenTrace", "compare", "load_golden", "replay"]
