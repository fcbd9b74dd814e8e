"""`spread` scenario: MPE cooperative navigation (simple_spread), batched
over envs in PyTorch.

Counterpart of :mod:`dcc_tpu.envs.spread`: N agents spread to occupy M
landmarks. The reward is the negative sum over landmarks of the distance to
the closest agent, minus a collision penalty per agent pair and the
out-of-bounds terms, times N (the shared-reward sum). Episodes end by time
limit or by leaving the hard bound. Every tensor of the
:class:`~dcc_tpu_torch.envs.coverage.EnvState` has a leading env axis.

The reset draws agents and landmarks U(-1, 1) from an explicit
``torch.Generator``, where the JAX package draws from a key per env.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import resolve_device
from .coverage import EnvState, StepOut


class SpreadConfig(NamedTuple):
    """Static config of the spread scenario; field names and defaults match
    :class:`dcc_tpu.envs.spread.SpreadConfig`."""

    n_agents: int = 4
    n_landmarks: int = 4
    max_ep_len: int = 150
    dt: float = 0.1
    damping: float = 0.25
    max_speed: float = 0.5
    sensitivity: float = 5.0
    agent_size: float = 0.15
    occupy_radius: float = 0.1  # a landmark counts as occupied within this
    collision_penalty: float = 1.0
    soft_bound: float = 1.0
    hard_bound: float = 1.5
    discrete_actions: bool = False
    time_limit: bool = True

    @property
    def n_pois(self) -> int:  # the registry's generic name for the landmarks
        return self.n_landmarks

    @property
    def obs_dim(self) -> int:
        # [vel(2), pos(2), rel-landmark(2M), rel-agent(2(N-1))]
        return 4 + 2 * self.n_landmarks + 2 * (self.n_agents - 1)

    @property
    def share_obs_dim(self) -> int:
        return self.n_agents * self.obs_dim

    @property
    def action_dim(self) -> int:
        return 5 if self.discrete_actions else 2

    # the action interface the trainers read from coverage's EnvConfig
    @property
    def resolved_action_mode(self) -> str:
        return "discrete" if self.discrete_actions else "continuous"

    @property
    def action_head_kind(self) -> str:
        return "categorical" if self.discrete_actions else "gaussian"

    @property
    def action_head_dims(self) -> tuple:
        return ()

    @property
    def action_width(self) -> int:
        return 1 if self.discrete_actions else 2

    @property
    def random_reset(self) -> bool:
        return True


_MOVES = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))


def reset(cfg: SpreadConfig, n_envs: int, dtype: torch.dtype = torch.float32, device=None,
          generator: Optional[torch.Generator] = None) -> EnvState:
    """Reset E envs: agents, then landmarks, U(-1, 1) from ``generator``
    (on ``device``, CUDA unless the caller asks for the CPU)."""
    if generator is None:
        raise ValueError("the spread reset draws agents and landmarks: pass a generator")
    device = resolve_device(device)
    n, m = cfg.n_agents, cfg.n_landmarks
    kw = dict(dtype=dtype, device=device)
    pos = torch.rand((n_envs, n, 2), generator=generator, **kw) * 2.0 - 1.0
    poi = torch.rand((n_envs, m, 2), generator=generator, **kw) * 2.0 - 1.0
    return EnvState(
        pos=pos,
        vel=torch.zeros((n_envs, n, 2), **kw),
        poi_pos=poi,
        poi_vel=torch.zeros((n_envs, m, 2), **kw),
        energy=torch.zeros((n_envs, m), **kw),
        poi_done=torch.zeros((n_envs, m), dtype=torch.bool, device=device),
        t=torch.zeros((n_envs,), dtype=torch.int32, device=device),
    )


def observation(cfg: SpreadConfig, state: EnvState) -> torch.Tensor:
    """(E, N, obs_dim): own vel, own pos, landmark offsets, the other
    agents' offsets in agent order."""
    n = cfg.n_agents
    e = state.pos.shape[0]
    others = torch.tensor([[j for j in range(n) if j != i] for i in range(n)],
                          dtype=torch.long, device=state.pos.device)
    rel_l = state.poi_pos[:, None, :, :] - state.pos[:, :, None, :]  # (E, N, M, 2)
    rel_a = state.pos[:, others] - state.pos[:, :, None, :]  # (E, N, N-1, 2)
    return torch.cat([state.vel, state.pos, rel_l.reshape(e, n, -1),
                      rel_a.reshape(e, n, -1)], dim=-1)


def step(cfg: SpreadConfig, state: EnvState, action: torch.Tensor
         ) -> Tuple[EnvState, StepOut]:
    """Advance E envs one step on (E, N, ``action_width``) actions: Box
    forces, or with ``discrete_actions`` one move index {noop, -x, +x, -y,
    +y} (float indices truncated)."""
    n = cfg.n_agents
    e = state.pos.shape[0]
    dtype = state.pos.dtype
    if cfg.discrete_actions:
        table = torch.tensor(_MOVES, dtype=dtype, device=state.pos.device)
        action = table[action.reshape(e, n).to(torch.int32).long()]
    force = action.to(dtype) * cfg.sensitivity
    vel = state.vel * (1.0 - cfg.damping) + force * cfg.dt
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
    vel = torch.where(speed > cfg.max_speed,
                      vel / torch.clamp(speed, min=1e-20) * cfg.max_speed, vel)
    pos = state.pos + vel * cfg.dt

    d_al = torch.sqrt(torch.sum((pos[:, :, None, :] - state.poi_pos[:, None, :, :]) ** 2,
                                dim=-1))  # (E, N, M)
    min_d = torch.min(d_al, dim=1).values  # (E, M)
    occupied = min_d < cfg.occupy_radius
    # collisions between agent pairs (MPE is_collision: dist < 2 size)
    delta = pos[:, :, None, :] - pos[:, None, :, :]
    pd = torch.sqrt(torch.sum(delta * delta, dim=-1))
    n_coll = torch.sum(torch.tril(pd < 2.0 * cfg.agent_size, diagonal=-1).to(dtype),
                       dim=(1, 2))
    over = torch.clamp(torch.abs(pos) - cfg.soft_bound, min=0.0)
    out_hard = torch.any(torch.abs(pos) > cfg.hard_bound, dim=2)  # (E, N)
    per_agent = (-torch.sum(min_d, dim=1) - cfg.collision_penalty * n_coll
                 - 100.0 * (torch.sum(over, dim=(1, 2)) + torch.sum(out_hard.to(dtype), dim=1)))
    reward = n * per_agent  # the shared reward summed over the N agents

    done = torch.any(out_hard, dim=1)
    t_next = state.t + 1
    if cfg.time_limit:
        truncated = (t_next >= cfg.max_ep_len) & ~done
    else:
        truncated = torch.zeros_like(done)
    new_state = EnvState(
        pos=pos,
        vel=vel,
        poi_pos=state.poi_pos,
        poi_vel=state.poi_vel,
        energy=state.energy + occupied.to(dtype),
        poi_done=occupied,
        t=t_next,
    )
    return new_state, StepOut(
        obs=observation(cfg, new_state),
        reward=reward,
        done=done,
        coverage_rate=torch.mean(occupied.to(dtype), dim=1),
        truncated=truncated,
    )


def config_from_yaml(cfg: dict) -> SpreadConfig:
    """Merged-YAML dict -> SpreadConfig (the JAX package's key names)."""
    return SpreadConfig(
        n_agents=int(cfg.get("num_agents", 4)),
        n_landmarks=int(cfg.get("num_landmarks", cfg.get("num_pois", 4))),
        max_ep_len=int(cfg.get("max_ep_len", 150)),
        collision_penalty=float(cfg.get("collision_penalty", 1.0)),
        occupy_radius=float(cfg.get("occupy_radius", 0.1)),
        discrete_actions=bool(cfg.get("discrete_actions", False)),
        time_limit=bool(cfg.get("time_limit", True)),
    )
