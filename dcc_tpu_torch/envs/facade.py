"""Gym-style facades over the batched coverage env: numpy in, numpy out.

Counterpart of :mod:`dcc_tpu.envs.facade`. ``DCEnv`` is one env:
``reset() -> obs (n_agents, obs_dim)``, ``step(actions) -> (obs, rewards
(n_agents,), dones (n_agents,), info)`` with ``info["coverage_rate"]``, and
the ``observation_space`` / ``action_space`` / ``share_observation_space``
lists; it does not reset itself. ``VecDCEnv`` steps ``n_envs`` envs in lock
step with the auto-reset of :func:`~dcc_tpu_torch.envs.vector.step_batch`:
a finished env returns its reset observation with the pre-reset reward and
done. The envs live on the port's device (CUDA unless ``device="cpu"``); a
random reset (``randomize_pois``, ``poi_speed``) draws from a generator
seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device
from .coverage import EnvConfig, observation, reset, step
from .spaces import Box, Discrete, MultiBinary, MultiDiscrete, TupleSpace
from .vector import reset_batch, step_batch


def _one_action_space(cfg: EnvConfig):
    """One agent's action space in the config's action mode."""
    mode = cfg.resolved_action_mode
    if mode == "discrete":
        return Discrete(cfg.action_dim)
    if mode == "multi_discrete":
        # per-axis branch index in [0, k-1] (decoded to {-1, 0, +1} forces)
        return MultiDiscrete([[0, k - 1] for k in cfg.action_head_dims])
    if mode == "multi_binary":
        return MultiBinary(cfg.action_dim)
    if mode == "mixed":
        box_dim, n_cat = cfg.action_head_dims
        return TupleSpace([Box(low=-1.0, high=1.0, shape=(box_dim,)), Discrete(n_cat)])
    return Box(low=-1.0, high=1.0, shape=(cfg.action_dim,))


def _make_spaces(cfg: EnvConfig):
    obs_space = [Box(low=-np.inf, high=np.inf, shape=(cfg.obs_dim,))
                 for _ in range(cfg.n_agents)]
    act_space = [_one_action_space(cfg) for _ in range(cfg.n_agents)]
    share_space = [Box(low=-np.inf, high=np.inf, shape=(cfg.share_obs_dim,))
                   for _ in range(cfg.n_agents)]
    return obs_space, act_space, share_space


class _Farm:
    """What both facades share: the config, the spaces, the device and the
    reset generator."""

    def __init__(self, cfg: Optional[EnvConfig], seed: int, device, kwargs):
        self.cfg = EnvConfig(**kwargs) if cfg is None else cfg
        self.n_agents = self.cfg.n_agents
        self.observation_space, self.action_space, self.share_observation_space = (
            _make_spaces(self.cfg))
        self.device = resolve_device(device)
        self.seed(seed)

    def seed(self, seed: int):
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _reset_gen(self):
        return self._gen if self.cfg.random_reset else None

    def _actions(self, actions) -> torch.Tensor:
        return torch.as_tensor(np.asarray(actions, dtype=np.float32), device=self.device)

    def close(self):
        pass


class DCEnv(_Farm):
    """One env (the reference's ``envs/mpe/uav_dcc.py`` API)."""

    def __init__(self, cfg: Optional[EnvConfig] = None, seed: int = 0, device=None, **kwargs):
        super().__init__(cfg, seed, device, kwargs)
        self.max_ep_len = self.cfg.max_ep_len
        self._state = None

    def reset(self) -> np.ndarray:
        self._state = reset(self.cfg, 1, device=self.device, generator=self._reset_gen())
        return observation(self.cfg, self._state)[0].cpu().numpy()

    def step(self, actions):
        self._state, out = step(self.cfg, self._state, self._actions(actions)[None])
        rew = np.full((self.n_agents,), float(out.reward[0]))  # shared team reward
        done = np.full((self.n_agents,), bool(out.done[0]))
        return out.obs[0].cpu().numpy(), rew, done, {"coverage_rate": float(out.coverage_rate[0])}

    def render(self, mode: str = "rgb_array"):
        from ..render.gif import draw_frame

        s = self._state
        return draw_frame(self.cfg, *(x[0].cpu().numpy()
                                      for x in (s.pos, s.poi_pos, s.energy, s.poi_done)))


class VecDCEnv(_Farm):
    """``n_envs`` envs in lock step with auto-reset (replaces the reference's
    Dummy / SubprocVecEnv)."""

    def __init__(self, cfg: Optional[EnvConfig] = None, n_envs: int = 16, seed: int = 0,
                 device=None, **kwargs):
        super().__init__(cfg, seed, device, kwargs)
        self.n_envs = n_envs
        self._states = None

    def reset(self) -> np.ndarray:
        self._states = reset_batch(self.cfg, self.n_envs, device=self.device,
                                   generator=self._reset_gen())
        return observation(self.cfg, self._states).cpu().numpy()

    def step(self, actions):
        self._states, out = step_batch(self.cfg, self._states, self._actions(actions),
                                       self._reset_gen())
        rews = np.repeat(out.reward.cpu().numpy()[:, None, None], self.n_agents, axis=1)
        dones = np.repeat(out.done.cpu().numpy()[:, None], self.n_agents, axis=1)
        infos = [{"coverage_rate": float(c)} for c in out.coverage_rate.cpu().numpy()]
        return out.obs.cpu().numpy(), rews, dones, infos

    def render(self, mode: str = "human", size: int = 256):
        """Every env's frame, tiled into one near-square grid (``human``) or
        as a stack (``rgb_array``)."""
        from ..render.gif import draw_frame, tile_images

        if self._states is None:
            raise RuntimeError("render() before reset()")
        s = [x.cpu().numpy() for x in (self._states.pos, self._states.poi_pos,
                                       self._states.energy, self._states.poi_done)]
        frames = np.stack([draw_frame(self.cfg, *(x[e] for x in s), size=size)
                           for e in range(self.n_envs)])
        return frames if mode == "rgb_array" else tile_images(frames)
