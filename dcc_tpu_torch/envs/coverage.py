"""Multi-UAV dynamic coverage environment in PyTorch, batched over envs.

The PyTorch counterpart of :mod:`dcc_tpu.envs.coverage`: the same physics,
reward and observation layout (cited there against the reference world),
written natively over a leading env axis instead of ``vmap``. Every tensor
of :class:`EnvState` is ``(E, ...)``; ``step`` advances all E envs at once.

Every action mode of the JAX package is decoded in :func:`step` (continuous,
discrete, multi_discrete, multi_binary, mixed). The default reset is
deterministic (the frozen PoI bank); ``randomize_pois`` and ``poi_speed``
draw the PoI layout and headings from an explicit ``torch.Generator`` on the
env's device, where the JAX package keeps a PRNG key per env. With
``compensated_forces`` on an f32 state the pull force's distance chain runs
in double-float (:mod:`dcc_tpu_torch.ops.df64`); the state may also be
float64 throughout (``reset(..., dtype=torch.float64)``), on the CPU or on
the GPU.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import df64
from ..utils import resolve_device

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

# Sentinel distance used by the reference for "self" / masked pairs.
_FAR = 1e5


class EnvConfig(NamedTuple):
    """Static environment configuration; field names and defaults match
    :class:`dcc_tpu.envs.EnvConfig` so configs carry over unchanged."""

    n_agents: int = 4
    n_pois: int = 20
    max_ep_len: int = 150
    r_cover: float = 0.2
    r_comm: float = 0.4
    comm_r_scale: float = 0.95
    comm_force_scale: float = 0.0
    dt: float = 0.1
    damping: float = 0.25
    max_speed: float = 0.5
    sensitivity: float = 5.0
    contact_force: float = 1e2
    contact_margin: float = 1e-3
    m_energy: float = 5.0
    rew_cover: float = 75.0
    rew_done: float = 1500.0
    rew_out: float = -100.0
    soft_bound: float = 1.0
    hard_bound: float = 1.5
    bb: float = 1.2
    size: float = 0.02
    discrete_actions: bool = False
    action_mode: str = ""
    randomize_pois: bool = False
    poi_speed: float = 0.0
    collision_penalty: float = 0.0
    collision_radius: float = 0.08
    fix_scaled_connectivity: bool = False
    compensated_forces: bool = False
    time_limit: bool = False

    @property
    def obs_dim(self) -> int:
        return 4 + 2 * (self.n_agents - 1) + 5 * self.n_pois

    @property
    def share_obs_dim(self) -> int:
        return self.n_agents * self.obs_dim

    @property
    def resolved_action_mode(self) -> str:
        if self.action_mode:
            return self.action_mode
        return "discrete" if self.discrete_actions else "continuous"

    @property
    def action_dim(self) -> int:
        return {
            "continuous": 2,
            "discrete": 5,
            "multi_discrete": 2,
            "multi_binary": 4,
            "mixed": 3,
        }[self.resolved_action_mode]

    @property
    def action_head_kind(self) -> str:
        """The actor head's kind (``models.actor_critic.Actor``)."""
        return {
            "continuous": "gaussian",
            "discrete": "categorical",
            "multi_discrete": "multi_discrete",
            "multi_binary": "multi_binary",
            "mixed": "mixed",
        }[self.resolved_action_mode]

    @property
    def action_head_dims(self) -> tuple:
        """Per-branch category counts (multi_discrete) or (continuous dim,
        discrete count) (mixed); empty otherwise."""
        mode = self.resolved_action_mode
        if mode == "multi_discrete":
            return (3, 3)
        if mode == "mixed":
            return (2, 3)
        return ()

    @property
    def action_width(self) -> int:
        """Width of one agent's action as the env takes it and MAPPO stores
        it: ``action_dim``, except one category index for discrete."""
        return 1 if self.resolved_action_mode == "discrete" else self.action_dim

    @property
    def random_reset(self) -> bool:
        """Whether a reset draws random numbers (and needs a generator)."""
        return self.randomize_pois or self.poi_speed > 0.0

    @property
    def effective_contact_force(self) -> float:
        return self.contact_force * self.comm_force_scale


@dataclass
class EnvState:
    """Dynamic state of E envs; every field has a leading env axis."""

    pos: torch.Tensor  # (E, N, 2)
    vel: torch.Tensor  # (E, N, 2)
    poi_pos: torch.Tensor  # (E, M, 2)
    poi_vel: torch.Tensor  # (E, M, 2)
    energy: torch.Tensor  # (E, M)
    poi_done: torch.Tensor  # (E, M) bool
    t: torch.Tensor  # (E,) int32

    def select(self, mask: torch.Tensor, other: "EnvState") -> "EnvState":
        """Per env: ``other`` where ``mask`` (E,) is true, else self."""

        def pick(a, b):
            m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, b, a)

        return EnvState(
            **{f.name: pick(getattr(self, f.name), getattr(other, f.name))
               for f in fields(self)}
        )


class StepOut(NamedTuple):
    obs: torch.Tensor  # (E, N, obs_dim)
    reward: torch.Tensor  # (E,) shared team reward
    done: torch.Tensor  # (E,) bool real termination
    coverage_rate: torch.Tensor  # (E,)
    truncated: torch.Tensor  # (E,) bool time-limit truncation


@functools.lru_cache(maxsize=None)
def default_poi_bank() -> np.ndarray:
    """The frozen 1000x2 U(-1,1) PoI position bank (data asset), read once
    (every auto-reset uses it); read-only."""
    bank = np.load(os.path.join(_ASSET_DIR, "pos_pois.npy"))
    bank.setflags(write=False)
    return bank


def reset(
    cfg: EnvConfig,
    n_envs: int,
    dtype: torch.dtype = torch.float32,
    device=None,
    poi_bank: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
) -> EnvState:
    """Reset E envs: agents at the origin at rest, PoIs from rows [0:M] of
    the frozen bank (the reference's deterministic reset) or, with
    ``randomize_pois``, drawn U(-1, 1) per env; with ``poi_speed`` each PoI
    gets a heading drawn U(0, 2 pi). The draws come from ``generator`` (on
    ``device``), which a random reset requires. ``device`` is CUDA unless
    the caller asks for the CPU; without a GPU the default raises."""
    device = resolve_device(device)
    n, m = cfg.n_agents, cfg.n_pois
    kw = dict(dtype=dtype, device=device)
    if cfg.random_reset and generator is None:
        raise ValueError("randomize_pois / poi_speed draw at every reset: pass a generator")
    if cfg.randomize_pois:
        poi = torch.rand((n_envs, m, 2), generator=generator, **kw) * 2.0 - 1.0
    else:
        bank = default_poi_bank() if poi_bank is None else np.asarray(poi_bank)
        poi = torch.as_tensor(bank[:m].copy(), **kw).expand(n_envs, m, 2).clone()
    if cfg.poi_speed > 0.0:
        theta = torch.rand((n_envs, m), generator=generator, **kw) * (2.0 * np.pi)
        poi_vel = cfg.poi_speed * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    else:
        poi_vel = torch.zeros((n_envs, m, 2), **kw)
    return EnvState(
        pos=torch.zeros((n_envs, n, 2), **kw),
        vel=torch.zeros((n_envs, n, 2), **kw),
        poi_pos=poi,
        poi_vel=poi_vel,
        energy=torch.zeros((n_envs, m), **kw),
        poi_done=torch.zeros((n_envs, m), dtype=torch.bool, device=device),
        t=torch.zeros((n_envs,), dtype=torch.int32, device=device),
    )


def _pairwise(pos: torch.Tensor) -> torch.Tensor:
    delta = pos[:, :, None, :] - pos[:, None, :, :]
    return torch.sqrt(torch.sum(delta * delta, dim=-1))


def connectivity(cfg: EnvConfig, pos: torch.Tensor):
    """Adjacency matrices and strong-connectivity indicators of (E, N, 2)
    positions; keeps the reference's unscaled-chain quirk unless
    ``fix_scaled_connectivity`` (see ``dcc_tpu.envs.coverage.connectivity``)."""
    n = cfg.n_agents
    dtype = pos.dtype
    raw = _pairwise(pos)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    far = torch.tensor(_FAR, dtype=dtype, device=pos.device)
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    dist = torch.where(eye, far, raw)
    thresh = cfg.r_comm * 2.0
    adj = torch.where(eye, zero, (raw < thresh).to(dtype))
    adj_ = torch.where(eye, zero, (raw < cfg.comm_r_scale * thresh).to(dtype))

    ident = eye.to(dtype).expand_as(adj)
    chain, chain_s = ident, ident
    total = torch.zeros_like(adj)
    total_s = torch.zeros_like(adj)
    for _ in range(n - 1):
        chain = chain @ adj
        chain_s = chain_s @ adj_ if cfg.fix_scaled_connectivity else chain @ adj_
        total = total + chain
        total_s = total_s + chain_s
    connect = torch.all((ident + total > 0).flatten(1), dim=1)
    connect_s = torch.all((ident + total_s > 0).flatten(1), dim=1)
    return dist, adj, adj_, connect, connect_s


def _pull_force(cfg: EnvConfig, delta: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Softplus-shaped pull force; ``delta = pos_a - pos_b``, returns the
    force on *b*. Softplus as ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    dist_max = 2.0 * cfg.r_comm * cfg.comm_r_scale
    k = cfg.contact_margin
    arg = (dist - dist_max) / k
    penetration = torch.logaddexp(arg, torch.zeros_like(arg)) * k
    return cfg.effective_contact_force * delta / dist * penetration


def _pull_force_df64(cfg: EnvConfig, delta) -> torch.Tensor:
    """The pull force of :func:`_pull_force` with its distance -> softplus
    argument -> penetration chain in double-float (``compensated_forces``;
    ``dcc_tpu.envs.coverage._pull_force_df64``): no f32 rounding of the
    distance for the 1 / contact_margin argument scale to amplify.
    ``delta`` is an exact (hi, lo) pair of ``pos_a - pos_b``, (..., 2)
    each; returns the f32 force on *b*, (..., 2). The x and y components
    share each op."""
    const = lambda v: df64.from_f64(v, device=delta[0].device)
    sq = df64.mul(delta, delta)
    d = df64.sqrt(df64.add((sq[0][..., 0], sq[1][..., 0]), (sq[0][..., 1], sq[1][..., 1])))
    k = const(cfg.contact_margin)
    arg = df64.div(df64.sub(d, const(2.0 * cfg.r_comm * cfg.comm_r_scale)), k)
    # softplus in double-float to first order: sp(hi + lo) ~= sp(hi) + sig(hi) * lo,
    # sp(hi) taken in f64 and split into a pair: the f32 libraries' exp and
    # log1p differ by an ulp or two between the CPU and the GPU
    sp64 = torch.logaddexp(arg[0].double(), torch.zeros_like(arg[0], dtype=torch.float64))
    sp_hi = sp64.float()
    sp = (sp_hi, (sp64 - sp_hi.double()).float() + torch.sigmoid(arg[0]) * arg[1])
    factor = df64.mul(df64.div(df64.mul(sp, k), d), const(cfg.effective_contact_force))
    return df64.to_f32(df64.mul((factor[0][..., None], factor[1][..., None]), delta))


def _connect_force(cfg: EnvConfig, pos, dist, adj_, connect_s) -> torch.Tensor:
    """Rule-based connectivity-preservation force (case 1: pull isolated
    agents to their nearest agent; case 2: pull the closest too-far pair),
    zero when already strongly connected. The partners are chosen in the
    state's dtype; with ``compensated_forces`` on an f32 state the force
    runs in double-float (:func:`_pull_force_df64`), in an f64 state the
    flag does nothing."""
    n = cfg.n_agents
    dtype = pos.dtype
    e = pos.shape[0]
    isolated = torch.sum(adj_, dim=1) == 0  # (E, N) column sums
    any_isolated = torch.any(isolated, dim=1)

    # case 1's partner: the nearest agent of every agent
    b1 = torch.argmin(dist, dim=2)  # (E, N)
    idx = b1[..., None].expand(-1, -1, 2)
    partner1 = torch.gather(pos, 1, idx)
    # case 2's pair: the global closest pair farther apart than the scaled radius
    far = torch.tensor(_FAR, dtype=dtype, device=pos.device)
    masked = torch.where(dist < cfg.comm_r_scale * 2.0 * cfg.r_comm, far, dist)
    flat = torch.argmin(masked.reshape(e, -1), dim=1)
    ia, ib = flat // n, flat % n
    rows = torch.arange(e, device=pos.device)
    if cfg.compensated_forces and dtype == torch.float32:
        # both cases' pairs in one double-float chain; the exact differences
        # come from gathers, never from one-hot products (a TF32 or bf16
        # product would round the operands and break two_diff)
        a = torch.cat([pos, pos[rows, ia][:, None]], dim=1)
        b = torch.cat([partner1, pos[rows, ib][:, None]], dim=1)
        f = _pull_force_df64(cfg, df64.two_diff(a, b))
        f1, f2 = f[:, :n], f[:, n:]
    else:
        d1 = torch.min(dist, dim=2, keepdim=True).values
        f1 = _pull_force(cfg, pos - partner1, d1)
        d2 = torch.min(masked.reshape(e, -1), dim=1).values[:, None]
        f2 = _pull_force(cfg, pos[rows, ia] - pos[rows, ib], d2)[:, None, :]
    fw = f1 * isolated.to(dtype)[..., None]
    case1 = -fw + torch.zeros_like(fw).scatter_add(1, idx, fw)
    hot_a = torch.nn.functional.one_hot(ia, n).to(dtype)[..., None]
    hot_b = torch.nn.functional.one_hot(ib, n).to(dtype)[..., None]
    case2 = hot_b * f2 - hot_a * f2

    force = torch.where(any_isolated[:, None, None], case1, case2)
    return torch.where(connect_s[:, None, None], torch.zeros_like(force), force)


def observation(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """(E, N, obs_dim): [vel(2), pos(2), other-agent relative positions
    (2*(N-1)), per PoI (rel(2), energy, m_energy, done)]."""
    n, m = cfg.n_agents, cfg.n_pois
    e = state.pos.shape[0]
    dtype = state.pos.dtype
    others = torch.tensor(
        [[j for j in range(n) if j != i] for i in range(n)],
        dtype=torch.long, device=state.pos.device,
    )
    rel_agents = state.pos[:, others] - state.pos[:, :, None, :]  # (E,N,N-1,2)
    rel_pois = state.poi_pos[:, None, :, :] - state.pos[:, :, None, :]
    poi_feat = torch.stack(
        [
            state.energy,
            torch.full_like(state.energy, cfg.m_energy),
            state.poi_done.to(dtype),
        ],
        dim=-1,
    )  # (E, M, 3)
    poi_block = torch.cat(
        [rel_pois, poi_feat[:, None].expand(e, n, m, 3)], dim=-1
    ).reshape(e, n, 5 * m)
    return torch.cat(
        [state.vel, state.pos, rel_agents.reshape(e, n, -1), poi_block], dim=-1
    )


def decode_action(cfg: EnvConfig, action: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(E, N, ``action_width``) actions of the config's mode -> (E, N, 2)
    forces in [-1, 1] (before ``sensitivity``), as ``dcc_tpu.envs.step``:

    * continuous: the Box action itself;
    * discrete: index {0: noop, 1: -x, 2: +x, 3: -y, 4: +y}, float indices
      truncated to int32;
    * multi_discrete: per-axis branch index {0, 1, 2} -> {-1, 0, +1};
    * multi_binary: thruster bits (+x, -x, +y, -y) -> net axis forces;
    * mixed: Box(2) direction times the throttle {0.5, 1.0, 1.5} of the
      rounded (half to even, as ``jnp.round``) index in the last column."""
    mode = cfg.resolved_action_mode
    e, n = action.shape[0], cfg.n_agents
    if mode == "discrete":
        i = action.reshape(e, n).to(torch.int32)
        axis = lambda neg, pos: (i == pos).to(dtype) - (i == neg).to(dtype)
        return torch.stack([axis(1, 2), axis(3, 4)], dim=-1)
    action = action.to(dtype)
    if mode == "multi_discrete":
        return action.reshape(e, n, 2) - 1.0
    if mode == "multi_binary":
        b = action.reshape(e, n, 4)
        return torch.stack([b[..., 0] - b[..., 1], b[..., 2] - b[..., 3]], dim=-1)
    if mode == "mixed":
        a = action.reshape(e, n, 3)
        return a[..., :2] * (0.5 * (torch.round(a[..., 2:3]) + 1.0))
    return action


def step(cfg: EnvConfig, state: EnvState, action: torch.Tensor):
    """Advance E envs one step; ``action`` is (E, N, ``action_width``) in
    the config's action mode (:func:`decode_action`). Returns the new state
    and the :class:`StepOut` of the transition."""
    n = cfg.n_agents
    dtype = state.pos.dtype
    action = decode_action(cfg, action, dtype)

    # connectivity on the OLD positions, then action + pull force
    force = action * cfg.sensitivity
    if cfg.effective_contact_force > 0.0:
        dist, _, adj_, _, connect_s = connectivity(cfg, state.pos)
        force = force + _connect_force(cfg, state.pos, dist, adj_, connect_s)

    # semi-implicit Euler with damping and speed clamp
    vel = state.vel * (1.0 - cfg.damping) + force * cfg.dt
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
    vel = torch.where(
        speed > cfg.max_speed,
        vel / torch.clamp(speed, min=1e-20) * cfg.max_speed,
        vel,
    )
    pos = state.pos + vel * cfg.dt

    # moving PoIs drift, bounce off the +-1 box and are clipped to it
    if cfg.poi_speed > 0.0:
        poi_pos = state.poi_pos + state.poi_vel * cfg.dt
        poi_vel = torch.where(torch.abs(poi_pos) > 1.0, -state.poi_vel, state.poi_vel)
        poi_pos = torch.clamp(poi_pos, -1.0, 1.0)
    else:
        poi_pos, poi_vel = state.poi_pos, state.poi_vel

    # PoI energy on the NEW positions
    d_ap = torch.sqrt(
        torch.sum((pos[:, :, None, :] - poi_pos[:, None, :, :]) ** 2, dim=-1)
    )  # (E, N, M)
    cover_cnt = torch.sum((d_ap <= cfg.r_cover).to(dtype), dim=1)
    energy = torch.where(state.poi_done, state.energy, state.energy + cover_cnt)
    newly_done = (~state.poi_done) & (energy >= cfg.m_energy)
    poi_done = state.poi_done | newly_done
    coverage_rate = torch.mean(poi_done.to(dtype), dim=1)

    # shared reward: each term counted once per agent, the cover bonus once
    min_dist = torch.min(d_ap, dim=1).values
    r_track = -torch.sum(torch.where(poi_done, torch.zeros_like(min_dist), min_dist), dim=1)
    all_done = torch.all(poi_done, dim=1)
    r_done = cfg.rew_done * all_done.to(dtype)
    over = torch.clamp(torch.abs(pos) - cfg.soft_bound, min=0.0)
    out_hard = torch.any(torch.abs(pos) > cfg.hard_bound, dim=2)
    r_oob = cfg.rew_out * (
        torch.sum(over, dim=(1, 2)) + torch.sum(out_hard.to(dtype), dim=1)
    )
    per_agent_part = r_track + r_done + r_oob
    if cfg.collision_penalty > 0.0:
        close = _pairwise(pos) < cfg.collision_radius
        n_coll = torch.sum(torch.tril(close, diagonal=-1).to(dtype), dim=(1, 2))
        per_agent_part = per_agent_part - cfg.collision_penalty * n_coll
    reward = n * per_agent_part + cfg.rew_cover * torch.sum(newly_done.to(dtype), dim=1)

    done = torch.any(out_hard, dim=1) | all_done
    t_next = state.t + 1
    if cfg.time_limit:
        truncated = (t_next >= cfg.max_ep_len) & ~done
    else:
        truncated = torch.zeros_like(done)

    new_state = EnvState(
        pos=pos,
        vel=vel,
        poi_pos=poi_pos,
        poi_vel=poi_vel,
        energy=energy,
        poi_done=poi_done,
        t=t_next,
    )
    obs = observation(cfg, new_state)
    return new_state, StepOut(obs, reward, done, coverage_rate, truncated)
