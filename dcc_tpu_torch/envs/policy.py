"""Scripted / interactive debug policies (numpy in, numpy out).

The port's copy of :mod:`dcc_tpu.envs.policy`. The reference ships a pyglet
keyboard teleop policy (``envs/mpe/multiagent/policy.py:13-52``, unused by
training); headless hosts have no window system, so the interactive analog
reads WASD-style commands from stdin. A scripted nearest-PoI heuristic
serves automated debugging and as a non-learning baseline.
"""

from __future__ import annotations

import sys

import numpy as np


class Policy:
    def action(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class HeuristicCoveragePolicy(Policy):
    """Steer each agent toward its nearest not-done PoI (proportional control
    on the relative position with velocity damping). Operates on the
    observation layout of scenarios/coverage.py:99-110."""

    def __init__(self, n_agents: int = 4, n_pois: int = 20, k_p: float = 1.0, k_d: float = 0.6):
        self.n_agents, self.n_pois = n_agents, n_pois
        self.k_p, self.k_d = k_p, k_d

    def action(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs)
        n = self.n_agents
        vel = obs[:, 0:2]
        poi_block = obs[:, 4 + 2 * (n - 1):].reshape(n, self.n_pois, 5)
        rel = poi_block[:, :, 0:2]
        done = poi_block[:, :, 4] > 0.5
        dist = np.linalg.norm(rel, axis=-1)
        dist = np.where(done, np.inf, dist)
        # all done: hold position
        tgt = np.argmin(dist, axis=-1)
        rel_t = rel[np.arange(n), tgt]
        act = self.k_p * rel_t - self.k_d * vel
        norm = np.maximum(np.linalg.norm(act, axis=-1, keepdims=True), 1e-8)
        act = act / np.maximum(norm, 1.0)  # clip to unit ball
        act[np.isinf(dist[np.arange(n), tgt])] = 0.0
        return act.astype(np.float32)


class InteractivePolicy(Policy):
    """stdin teleop for one agent (headless replacement for the pyglet
    key-handler policy): w/a/s/d sets the force direction, anything else is
    a no-op. Other agents hold still."""

    def __init__(self, n_agents: int = 4, agent_idx: int = 0, stream=None):
        self.n_agents = n_agents
        self.agent_idx = agent_idx
        self.stream = stream or sys.stdin

    def action(self, obs: np.ndarray) -> np.ndarray:
        act = np.zeros((self.n_agents, 2), np.float32)
        cmd = self.stream.readline().strip().lower()
        vec = {
            "w": (0.0, 1.0),
            "s": (0.0, -1.0),
            "a": (-1.0, 0.0),
            "d": (1.0, 0.0),
        }.get(cmd[:1], (0.0, 0.0))
        act[self.agent_idx] = vec
        return act
