"""MADDPG: per-agent DDPG with centralized critics, in PyTorch.

Counterpart of :mod:`dcc_tpu.algos.maddpg`: a tanh rlkit actor per agent on
its own observation, a centralized Q per agent on the concat of all
observations and all actions, target networks with soft updates (tau),
Ornstein-Uhlenbeck exploration per env x agent, a device-resident circular
replay buffer, and per update: the critic's TD step on
``reward_scale * r + (1 - done) * gamma * Q_target(next)``, then the actor's
step on ``-Q_i`` of the joint action with agent i's column replaced by its
own action (the critic after this update's step) plus ``action_reg`` times
the mean squared pre-tanh output. ``clip_grad`` > 0 clips every gradient
element before Adam.

As in the JAX package the A agents' parameters are stacked on a leading
agent axis (:class:`~dcc_tpu_torch.models.rlkit_mlp.RlkitMlp` with
``n_stack = A``), and every per-agent step is one batched product over that
axis; no Python loop runs over agents. One Adam per network family updates
the stacked tensors: Adam (and the value clip) is elementwise with one step
count, so it equals the JAX package's vmapped optax states.

The buffer's ``ptr`` and ``size`` and the step counter are host integers:
their values follow from the env count and the capacity alone, so the
step loop never waits for the device. The buffer indices, the OU noise, the
warm-up actions and a random env reset draw from the state's one
``torch.Generator``; ``collect``, ``update_once`` and ``train_iteration``
also take injected draws (JAX's, in the tests).

With a :class:`~dcc_tpu_torch.parallel.mesh.Mesh` (``mesh=``) this is the
JAX package's "replicated buffer + sharded collection": each rank steps its
block of the env farm, OU state and observations, drawing the noise of all
``n_envs`` envs from the generator every rank holds and keeping its rows;
every step all-gathers the fresh transitions into the replicated buffer in
global env order, and ``update_once`` runs identically on every rank (no
gradient sum). ``eval_iteration`` runs all its envs on every rank.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..envs import get_scenario
from ..models.rlkit_mlp import RlkitMlp
from ..parallel.mesh import Mesh, env_fns
from ..utils import resolve_device
from ..utils.profiling import timed_phase


class MADDPGConfig(NamedTuple):
    """Field names and defaults of :class:`dcc_tpu.algos.maddpg.MADDPGConfig`
    (``reward_scale``, ``action_reg`` and ``clip_grad`` are its learning
    stabilizers; ``clip_grad`` 0 is off)."""

    actor_lr: float = 5e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01
    hidden_sizes: Tuple[int, ...] = (64,)
    buffer_capacity: int = 100_000
    batch_size: int = 256
    ou_mu: float = 0.0
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    n_envs: int = 16
    steps_per_iter: int = 150
    updates_per_iter: int = 50
    warmup_steps: int = 1000  # env steps of uniform random actions before the policy acts
    reward_scale: float = 0.01
    action_reg: float = 1e-3
    clip_grad: float = 0.0


@dataclass
class ReplayBuffer:
    """Circular store of joint transitions on the device; ``ptr`` and
    ``size`` on the host."""

    obs: torch.Tensor  # (cap, N, D)
    actions: torch.Tensor  # (cap, N, act)
    rewards: torch.Tensor  # (cap, 1) shared team reward
    next_obs: torch.Tensor  # (cap, N, D)
    dones: torch.Tensor  # (cap, 1)
    ptr: int = 0
    size: int = 0

    TENSORS = ("obs", "actions", "rewards", "next_obs", "dones")


@dataclass
class MADDPGState:
    """Mutable training state: the stacked networks, their targets and
    Adams, the buffer, the env farm (states, observations, OU noise), the
    counters and the generator."""

    actor: RlkitMlp
    critic: RlkitMlp
    target_actor: RlkitMlp
    target_critic: RlkitMlp
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    buffer: ReplayBuffer
    env_states: object  # the scenario's EnvState of the E envs
    obs: torch.Tensor  # (E, N, D)
    ou_state: torch.Tensor  # (E, N, act)
    total_steps: int  # env steps collected (E a step)
    iteration: int  # outer iterations finished
    generator: torch.Generator

    NETS = ("actor", "critic", "target_actor", "target_critic")


class MADDPG:
    def __init__(self, cfg: MADDPGConfig, env_cfg, device=None, scenario: str = "coverage",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.env_cfg = env_cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and mesh else device)
        if mesh is not None and not mesh.divides(cfg.n_envs):
            raise ValueError(
                f"n_envs ({cfg.n_envs}) must divide over the mesh ({mesh.size} devices)")
        self.scenario = scenario
        # the collection's env farm: this rank's block of the n_envs envs
        self.rows = slice(0, cfg.n_envs) if mesh is None else mesh.rows(cfg.n_envs)
        self._reset_batch, self._step_batch = env_fns(scenario, mesh, cfg.n_envs)
        self._obs_fn = get_scenario(scenario)["observation"]
        if getattr(env_cfg, "resolved_action_mode", "continuous") != "continuous":
            raise NotImplementedError(
                "MADDPG is a continuous-control algorithm (tanh actor, "
                "maddpg.py:13-17); use MAPPO for discrete action modes"
            )
        self.n_agents = env_cfg.n_agents
        self.obs_dim = env_cfg.obs_dim
        self.act_dim = env_cfg.action_dim

    # ------------------------------------------------------------------
    def make_networks(self, seed: int = 0) -> Tuple[RlkitMlp, RlkitMlp]:
        """The stacked actors and critics, initialized on the CPU from
        ``seed`` and moved to the device."""
        n, d, a = self.n_agents, self.obs_dim, self.act_dim
        gen = torch.Generator().manual_seed(seed)
        h = self.cfg.hidden_sizes
        actor = RlkitMlp(d, a, h, n_stack=n, tanh_output=True, generator=gen)
        critic = RlkitMlp(n * d + n * a, 1, h, n_stack=n, generator=gen)
        return actor.to(self.device), critic.to(self.device)

    def init_state(self, seed: int = 0, actor: Optional[RlkitMlp] = None,
                   critic: Optional[RlkitMlp] = None) -> MADDPGState:
        """Fresh state; ``actor`` / ``critic`` replace the seeded networks
        (e.g. parameters converted from the JAX package). The targets start
        as copies of the online networks."""
        cfg = self.cfg
        if actor is None or critic is None:
            actor, critic = self.make_networks(seed)
        n, d, a = self.n_agents, self.obs_dim, self.act_dim
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        n_local = self.rows.stop - self.rows.start
        env_states = self._reset_batch(self.env_cfg, n_local, device=self.device,
                                       generator=self._env_gen(gen))
        f32 = dict(dtype=torch.float32, device=self.device)
        cap = cfg.buffer_capacity
        buffer = ReplayBuffer(
            obs=torch.zeros((cap, n, d), **f32),
            actions=torch.zeros((cap, n, a), **f32),
            rewards=torch.zeros((cap, 1), **f32),
            next_obs=torch.zeros((cap, n, d), **f32),
            dones=torch.zeros((cap, 1), **f32),
        )
        st = MADDPGState(
            actor=actor,
            critic=critic,
            target_actor=_frozen_copy(actor),
            target_critic=_frozen_copy(critic),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=cfg.actor_lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=cfg.critic_lr),
            buffer=buffer,
            env_states=env_states,
            obs=self._obs_fn(self.env_cfg, env_states),
            ou_state=torch.full((n_local, n, a), cfg.ou_mu, **f32),
            total_steps=0,
            iteration=0,
            generator=gen,
        )
        self.replicate(st)
        return st

    def replicate(self, st: MADDPGState) -> None:
        """Under a mesh, every rank's networks, targets and Adam moments set
        to the coordinator's (after init and after a load). No-op without
        one."""
        if self.mesh is not None:
            self.mesh.replicate_([getattr(st, net) for net in MADDPGState.NETS],
                                 (st.actor_opt, st.critic_opt))

    def _env_gen(self, gen: torch.Generator) -> Optional[torch.Generator]:
        return gen if self.env_cfg.random_reset else None

    # ------------------------------------------------------------------
    def _actors(self, net: RlkitMlp, obs: torch.Tensor) -> torch.Tensor:
        """Agent i's actor on agent i's observation: obs (..., N, D) ->
        (..., N, act)."""
        n = self.n_agents
        out = net(obs.reshape(-1, n, obs.shape[-1]).transpose(0, 1))  # (N, B, act)
        return out.transpose(0, 1).reshape(*obs.shape[:-1], out.shape[-1])

    def _critics(self, net: RlkitMlp, q_in: torch.Tensor) -> torch.Tensor:
        """Every agent's critic: q_in (B, W), shared, or (N, B, W) per
        agent -> (N, B, 1)."""
        if q_in.dim() == 2:
            q_in = q_in.expand(self.n_agents, *q_in.shape)
        return net(q_in)

    @torch.no_grad()
    def act(self, ts: MADDPGState, obs: torch.Tensor, deterministic: bool = True,
            generator=None):
        """The deterministic policy on agent rows in env order, (E*N, D) ->
        ((E*N, act), None), the interface of ``MAPPO.act`` (DDPG has no
        log-probs)."""
        action = self._actors(ts.actor, obs.reshape(-1, self.n_agents, obs.shape[-1]))
        return action.reshape(-1, self.act_dim), None

    def _ou_step(self, ou: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """One Ornstein-Uhlenbeck step on standard normal ``noise``."""
        cfg = self.cfg
        return ou + (cfg.ou_theta * (cfg.ou_mu - ou) + cfg.ou_sigma * noise)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect(self, st: MADDPGState, n_steps: int, noise: Optional[torch.Tensor] = None,
                uniform: Optional[torch.Tensor] = None):
        """``n_steps`` env steps with exploration into the buffer. The action
        is U(-1, 1) while fewer than ``warmup_steps`` env steps were
        collected, else ``clip(actor + OU, -1, 1)``; the OU state steps
        every step and resets to ``ou_mu`` where an episode ended. ``noise``
        / ``uniform`` (n_steps, E, N, act) replace the generator's normal
        and U(-1, 1) draws. Returns the mean over steps of the mean reward
        and the mean over envs of each env's best coverage, on the
        device. Under a mesh the rank steps its rows of the E envs, and
        the buffer and the metrics take every rank's."""
        cfg, env_cfg = self.cfg, self.env_cfg
        E, cap = cfg.n_envs, cfg.buffer_capacity
        gen, buf, rows = st.generator, st.buffer, self.rows
        shape = (E, *st.ou_state.shape[1:])
        rewards, cover = [], []
        for t in range(n_steps):
            eps = (noise[t] if noise is not None else torch.randn(
                shape, generator=gen, device=self.device))[rows]
            ou = self._ou_step(st.ou_state, eps)
            if st.total_steps < cfg.warmup_steps:
                action = (uniform[t] if uniform is not None else (
                    torch.rand(shape, generator=gen, device=self.device) * 2.0 - 1.0))[rows]
            else:
                action = torch.clamp(self._actors(st.actor, st.obs) + ou, -1.0, 1.0)
            env_states, out = self._step_batch(env_cfg, st.env_states, action,
                                                self._env_gen(gen))
            # next_obs is the reset observation where an episode ended, and
            # done is the real termination alone (not truncation)
            obs, action_all, reward, next_obs, done, coverage = self._gather(
                st.obs, action, out.reward, out.obs, out.done.to(torch.float32),
                out.coverage_rate)
            idx = torch.arange(buf.ptr, buf.ptr + E, device=self.device) % cap
            buf.obs[idx] = obs
            buf.actions[idx] = action_all
            buf.rewards[idx] = reward[:, None]
            buf.next_obs[idx] = next_obs
            buf.dones[idx] = done[:, None]
            buf.ptr = (buf.ptr + E) % cap
            buf.size = min(buf.size + E, cap)
            st.env_states, st.obs = env_states, out.obs
            st.ou_state = ou.masked_fill(out.done[:, None, None], cfg.ou_mu)
            st.total_steps += E
            rewards.append(reward.mean())
            cover.append(coverage)
        return torch.stack(rewards).mean(), torch.stack(cover).max(dim=0).values.mean()

    def _gather(self, *fields: torch.Tensor):
        """Each f32 field of this rank's envs (E_local, ...) as that of all
        E envs in global env order, in one collective (the fields
        themselves without a mesh)."""
        if self.mesh is None:
            return fields
        E = self.cfg.n_envs
        flat = torch.cat([f.reshape(f.shape[0], -1) for f in fields], dim=1)
        full = self.mesh.all_gather(flat, E)
        out, i = [], 0
        for f in fields:
            w = f[0].numel()
            out.append(full[:, i:i + w].reshape(E, *f.shape[1:]).contiguous())
            i += w
        return out

    # ------------------------------------------------------------------
    def update_once(self, st: MADDPGState, idx: Optional[torch.Tensor] = None):
        """One gradient step of every agent's critic, then actor, then the
        soft target updates, on ``batch_size`` rows drawn with replacement
        from the buffer (``idx`` replaces the draw). Returns the mean over
        agents of the critic and the actor losses, on the device."""
        cfg = self.cfg
        n, B, buf = self.n_agents, cfg.batch_size, st.buffer
        if idx is None:
            idx = torch.randint(0, max(buf.size, 1), (B,), generator=st.generator,
                                device=self.device)
        obs_b, act_b = buf.obs[idx], buf.actions[idx]  # (B, N, D), (B, N, a)
        rew_b, nobs_b, done_b = buf.rewards[idx], buf.next_obs[idx], buf.dones[idx]
        obs_flat = obs_b.reshape(B, -1)

        with torch.no_grad():
            next_acts = self._actors(st.target_actor, nobs_b)
            q_next = self._critics(st.target_critic,
                                   torch.cat([nobs_b.reshape(B, -1), next_acts.reshape(B, -1)],
                                             dim=-1))
            target = cfg.reward_scale * rew_b + (1.0 - done_b) * cfg.gamma * q_next
        q = self._critics(st.critic, torch.cat([obs_flat, act_b.reshape(B, -1)], dim=-1))
        c_loss = torch.mean((q - target) ** 2, dim=(1, 2))  # (N,)
        self._step(st.critic, st.critic_opt, c_loss)

        # agent i's loss replaces column i of the joint action by its own
        # action, through the critic after this update's step
        own, pre = st.actor(obs_b.transpose(0, 1), return_pre=True)  # (N, B, a)
        eye = torch.eye(n, dtype=obs_b.dtype, device=self.device)[:, None, :, None]
        acts = act_b[None] * (1.0 - eye) + own[:, :, None, :] * eye  # (N, B, N, a)
        q_in_pi = torch.cat([obs_flat.expand(n, *obs_flat.shape), acts.reshape(n, B, -1)],
                            dim=-1)
        a_loss = -torch.mean(self._critics(st.critic, q_in_pi), dim=(1, 2))
        if cfg.action_reg > 0.0:
            a_loss = a_loss + cfg.action_reg * torch.mean(pre ** 2, dim=(1, 2))
        self._step(st.actor, st.actor_opt, a_loss)

        with torch.no_grad():
            for tgt, src in ((st.target_actor, st.actor), (st.target_critic, st.critic)):
                for tp, sp in zip(tgt.parameters(), src.parameters()):
                    tp.copy_(tp * (1.0 - cfg.tau) + sp * cfg.tau)
        return c_loss.detach().mean(), a_loss.detach().mean()

    def _step(self, net: RlkitMlp, opt: torch.optim.Optimizer, losses: torch.Tensor) -> None:
        """Adam step of ``net`` on the agents' ``losses`` (N,): agent i's
        parameters take the gradient of its own loss alone."""
        params = list(net.parameters())
        clip = self.cfg.clip_grad
        for p, g in zip(params, torch.autograd.grad(losses.sum(), params)):
            p.grad = g.clamp_(-clip, clip) if clip > 0.0 else g
        opt.step()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_iteration(self, st: MADDPGState, n_envs: int,
                       generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Deterministic-policy rollout of ``steps_per_iter`` steps from a
        fresh reset of ``n_envs`` envs, with auto-reset; a random reset draws
        from ``generator`` (default the state's). Returns the sum over
        steps of the mean reward and the mean over envs of each env's best
        coverage."""
        env_cfg = self.env_cfg
        env_gen = self._env_gen(st.generator if generator is None else generator)
        # every rank runs all n_envs envs, as JAX's replicated eval does
        reset_batch, step_batch = env_fns(self.scenario, None, n_envs)
        states = reset_batch(env_cfg, n_envs, device=self.device, generator=env_gen)
        obs = self._obs_fn(env_cfg, states)
        rewards, cover = [], []
        for _ in range(self.cfg.steps_per_iter):
            states, out = step_batch(env_cfg, states, self._actors(st.actor, obs), env_gen)
            obs = out.obs
            rewards.append(out.reward)
            cover.append(out.coverage_rate)
        r = torch.stack(rewards).mean(dim=1).sum()
        c = torch.stack(cover).max(dim=0).values.mean()
        reward, coverage = torch.stack([r, c]).tolist()
        return {"reward": reward, "coverage_rate": coverage}

    # ------------------------------------------------------------------
    def train_iteration(self, st: MADDPGState, timer=None,
                        noise: Optional[torch.Tensor] = None,
                        uniform: Optional[torch.Tensor] = None,
                        indices: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """Collect ``steps_per_iter`` steps, then, once the buffer holds
        ``batch_size`` rows, ``updates_per_iter`` updates (``indices``
        (updates_per_iter, batch_size) replaces their draws); an iteration
        without updates reports zero losses. Returns the metrics as floats:
        one wait for the device an iteration. With a
        :class:`~dcc_tpu_torch.utils.profiling.PhaseTimer` the collect and
        update phases are timed to their end on the device."""
        cfg = self.cfg
        with timed_phase(timer, "collect", self.device):
            reward, coverage = self.collect(st, cfg.steps_per_iter, noise, uniform)
        zero = torch.zeros((), device=self.device)
        qf_loss = policy_loss = zero
        if st.buffer.size >= cfg.batch_size:
            with timed_phase(timer, "update", self.device):
                losses = [self.update_once(st, None if indices is None else indices[u])
                          for u in range(cfg.updates_per_iter)]
                qf_loss, policy_loss = torch.stack([torch.stack(x) for x in losses]).mean(dim=0)
        st.iteration += 1
        values = torch.stack([reward, coverage, qf_loss, policy_loss]).tolist()
        return dict(zip(("reward", "coverage_rate", "qf_loss", "policy_loss"), values))


def _frozen_copy(net: RlkitMlp) -> RlkitMlp:
    """A copy of ``net`` with its own storage and no gradients: a target
    network that starts equal to the online one, not an alias of it."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    return target
