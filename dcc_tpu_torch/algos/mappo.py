"""Shared-parameter feed-forward MAPPO with a Gaussian actor, in PyTorch.

Counterpart of :mod:`dcc_tpu.algos.mappo` for the main path: fresh-reset
rollout over E batched envs -> ValueNorm-denormalized GAE -> ``ppo_epoch``
PPO epochs on one minibatch (clipped surrogate + clipped one-sided Huber
value loss + entropy bonus, two Adams with eps 1e-5, optax-style global-norm
clip per network, count-based linear LR decay).

The update runs one of two ways, as in the JAX package:

* autograd of the plain loss (``_ff_minibatch_update``), or
* the fused loss + gradient kernels K3 / K4 (``_update_fused_full``): the
  packed rows are built once, each epoch's value-normalizer scalars come
  from ``_norm_seq``, and ``_fused_core`` turns the SUM-reduced gradients
  into mean-loss gradients and steps the optimizers.

Dispatch mirrors ``MAPPO.__init__`` of the JAX package: "auto" selects the
GAE kernel K1 on CUDA, and the fused trunk K2 and fused loss K3 / K4 on CUDA
in bf16; "on" forces them (on CPU tensors that runs their plain versions).
Options this port does not run yet raise :class:`NotImplementedError`
naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..envs import EnvConfig, check_supported, observation, reset_batch, step_batch
from ..models import Actor, Critic
from ..models import distributions as D
from ..models import valuenorm as VN
from ..ops import fused_ppo as FP
from ..ops.cuda_gae import compute_gae_cuda
from ..ops.gae import compute_gae, discounted_returns
from ..utils import clip_by_global_norm_, global_norm, resolve_device


class MAPPOConfig(NamedTuple):
    """Algorithm hyperparameters; the same fields and defaults as
    :class:`dcc_tpu.algos.MAPPOConfig`. ``fused_block_rows`` is kept for key
    parity: the CUDA kernels size their row tiles from shared memory and the
    real row width, and ignore it."""

    clip_param: float = 0.2
    ppo_epoch: int = 15
    num_mini_batch: int = 1
    data_chunk_length: int = 10
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.01
    max_grad_norm: float = 10.0
    huber_delta: float = 10.0
    use_clipped_value_loss: bool = True
    use_huber_loss: bool = True
    use_max_grad_norm: bool = True
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_gae: bool = True
    use_proper_time_limits: bool = False
    use_popart: bool = False
    use_valuenorm: bool = True
    actor_lr: float = 5e-4
    critic_lr: float = 5e-4
    opti_eps: float = 1e-5
    weight_decay: float = 0.0
    use_linear_lr_decay: bool = True
    hidden_size: int = 256
    layer_n: int = 1
    use_relu: bool = True
    use_feature_normalization: bool = True
    use_orthogonal: bool = True
    gain: float = 0.01
    use_recurrent_policy: bool = False
    use_naive_recurrent: bool = False
    recurrent_n: int = 1
    use_centralized_v: bool = True
    share_policy: bool = True
    n_rollout_threads: int = 16
    episode_length: int = 150
    n_iters: int = 200
    gae_backend: str = "auto"  # auto | pallas (kernel K1) | xla (plain loop)
    compute_dtype: str = "float32"
    use_remat: bool = False
    update_chunks: int = 1
    fused_trunk: str = "auto"  # auto | on | off ("interpret" = on)
    fused_block_rows: int = 6144
    fused_fold: bool = True
    env_dtype: str = "float32"
    store_obs_bf16: bool = True
    fused_loss: str = "auto"  # auto | on | off ("interpret" = on)


@dataclass
class TrainState:
    """Mutable training state: networks, both optimizers, the value
    normalizer, counters and the rollout's random generator."""

    actor: Actor
    critic: Critic
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    vnorm: Optional[VN.ValueNormState]
    update_count: int  # optimizer steps taken (drives the LR schedule)
    iteration: int  # outer iterations finished
    generator: torch.Generator


class Trajectory(NamedTuple):
    """Time-major rollout storage; values / rewards / masks are per env."""

    obs: torch.Tensor  # (T+1, E, A, D)
    actions: torch.Tensor  # (T, E, A, act)
    log_probs: torch.Tensor  # (T, E, A, 1)
    values: torch.Tensor  # (T+1, E, 1)
    rewards: torch.Tensor  # (T, E, 1)
    masks: torch.Tensor  # (T+1, E, 1)
    coverage: torch.Tensor  # (T, E)
    bad_masks: torch.Tensor  # (T+1, E, 1)


class Metrics(NamedTuple):
    reward: float
    coverage_rate: float
    value_loss: float
    policy_loss: float
    dist_entropy: float
    actor_grad_norm: float
    critic_grad_norm: float
    ratio: float


def _mse(e: torch.Tensor) -> torch.Tensor:
    return e**2 / 2.0


def jnp_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as min(max(x, lo), hi): its gradient splits 50/50 at
    the bounds, where ``torch.clamp``'s is 1."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def normalize_advantages(adv: torch.Tensor) -> torch.Tensor:
    """(adv - mean) / (std + 1e-5) over all rows with the POPULATION std, as
    ``jnp.std`` (``torch.std`` defaults to the unbiased one)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)


def _resolve_switch(value: str, name: str, auto: bool) -> bool:
    if value in ("on", "interpret"):
        return True
    if value == "off":
        return False
    if value == "auto":
        return auto
    raise ValueError(f"unknown {name} {value!r}")


class MAPPO:
    def __init__(self, cfg: MAPPOConfig, env_cfg: EnvConfig, device=None):
        self.cfg = cfg
        self.env_cfg = env_cfg
        self.device = resolve_device(device)
        check_supported(env_cfg)
        if cfg.compute_dtype in ("bfloat16", "bf16"):
            self.bf16 = True
        elif cfg.compute_dtype in ("float32", "fp32", "f32"):
            self.bf16 = False
        else:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        unported = [
            (not cfg.share_policy, "separated per-agent policies (ROADMAP A8)"),
            (cfg.use_recurrent_policy or cfg.use_naive_recurrent,
             "recurrent policies (ROADMAP A7)"),
            (cfg.use_popart, "PopArt (ROADMAP A8)"),
            (cfg.num_mini_batch != 1,
             "num_mini_batch>1 (ROADMAP: nmb>1 and the fused minibatch path)"),
            (cfg.use_remat, "use_remat (ROADMAP A8)"),
            (cfg.env_dtype not in ("float32", "fp32", "f32"),
             "env_dtype other than float32 (ROADMAP A12)"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet")
        if not cfg.use_centralized_v:
            raise ValueError(
                "use_centralized_v=False: the critic is built on the team-concat "
                "observation, as in the JAX package's rollout"
            )

        on_cuda = self.device.type == "cuda"
        self.fused_trunk = _resolve_switch(cfg.fused_trunk, "fused_trunk", on_cuda and self.bf16)
        self.fused_loss = _resolve_switch(cfg.fused_loss, "fused_loss", on_cuda and self.bf16)
        if self.fused_trunk and not self.fused_loss:
            raise NotImplementedError(
                "the fused trunk under autograd needs the fused-trunk backward "
                "kernel, which is not ported yet (ROADMAP K2b); use fused_trunk="
                "'off' or fused_loss='on'"
            )
        if self.fused_loss and not cfg.fused_fold:
            raise NotImplementedError(
                "fused_fold=False is not ported yet (ROADMAP: fused_fold=False)"
            )
        if cfg.update_chunks > 1 and not self.fused_loss:
            raise NotImplementedError(
                "update_chunks>1 without the fused loss is not ported yet (ROADMAP A8)"
            )
        if cfg.gae_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown gae_backend {cfg.gae_backend!r}")
        self.gae_kernel = cfg.gae_backend == "pallas" or (
            cfg.gae_backend == "auto" and on_cuda
        )
        self.obs_dim = env_cfg.obs_dim
        self.cent_obs_dim = env_cfg.share_obs_dim
        self.store_dtype = (
            torch.bfloat16 if self.bf16 and cfg.store_obs_bf16 else torch.float32
        )
        self.net_dtype = torch.bfloat16 if self.bf16 else torch.float32
        self._updates_per_iter = cfg.ppo_epoch * cfg.num_mini_batch

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _trunk_kwargs(self, generator):
        cfg = self.cfg
        return dict(
            hidden_size=cfg.hidden_size,
            layer_n=cfg.layer_n,
            use_relu=cfg.use_relu,
            use_feature_normalization=cfg.use_feature_normalization,
            use_orthogonal=cfg.use_orthogonal,
            bf16=self.bf16,
            fused=self.fused_trunk,
            generator=generator,
        )

    def make_networks(self, seed: int = 0):
        """Actor and critic, initialized on the CPU from ``seed`` and moved
        to the device."""
        gen = torch.Generator().manual_seed(seed)
        actor = Actor(self.obs_dim, self.env_cfg.action_dim, self.cfg.gain,
                      **self._trunk_kwargs(gen))
        critic = Critic(self.cent_obs_dim, **self._trunk_kwargs(gen))
        return actor.to(self.device), critic.to(self.device)

    def _make_opt(self, params, lr: float) -> torch.optim.Optimizer:
        cfg = self.cfg
        if cfg.weight_decay:
            return torch.optim.AdamW(params, lr=lr, eps=cfg.opti_eps,
                                     weight_decay=cfg.weight_decay)
        return torch.optim.Adam(params, lr=lr, eps=cfg.opti_eps)

    def init_state(self, seed: int = 0, actor=None, critic=None) -> TrainState:
        """Fresh train state; ``actor`` / ``critic`` replace the seeded
        networks (e.g. with parameters converted from the JAX package)."""
        if actor is None or critic is None:
            actor, critic = self.make_networks(seed)
        cfg = self.cfg
        return TrainState(
            actor=actor,
            critic=critic,
            actor_opt=self._make_opt(actor.parameters(), cfg.actor_lr),
            critic_opt=self._make_opt(critic.parameters(), cfg.critic_lr),
            vnorm=VN.init(self.device) if cfg.use_valuenorm else None,
            update_count=0,
            iteration=0,
            generator=torch.Generator(device=self.device).manual_seed(seed + 1),
        )

    def lr_at(self, base_lr: float, count: int) -> float:
        """Linear decay by iteration, from the optimizer-step count: the
        first update already runs at base * (1 - 1/n_iters)."""
        if not self.cfg.use_linear_lr_decay:
            return base_lr
        it = count // self._updates_per_iter + 1
        return max(base_lr * (1.0 - it / self.cfg.n_iters), 0.0)

    # ------------------------------------------------------------------
    # acting
    # ------------------------------------------------------------------
    def act(self, ts: TrainState, obs, deterministic: bool = False, generator=None):
        """obs (..., D) -> (action (..., act), log_prob (..., 1))."""
        mean, log_std = ts.actor(obs)
        if deterministic:
            action = D.normal_mode(mean)
        else:
            action = D.normal_sample(mean, log_std, generator)
        return action, D.normal_log_prob(mean, log_std, action)

    def value(self, ts: TrainState, cent_obs):
        return ts.critic(cent_obs)

    def _denorm(self, ts: TrainState, v):
        return VN.denormalize(ts.vnorm, v) if self.cfg.use_valuenorm else v

    # ------------------------------------------------------------------
    # rollout
    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, ts: TrainState, n_envs: int, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> Trajectory:
        """Fresh-reset rollout of episode_length steps over n_envs envs."""
        cfg, env_cfg = self.cfg, self.env_cfg
        gen = ts.generator if generator is None else generator
        T, A, E = cfg.episode_length, env_cfg.n_agents, n_envs
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        states = reset_batch(env_cfg, E, device=dev)
        obs = observation(env_cfg, states)
        obs_buf = torch.empty((T + 1, E, A, self.obs_dim), dtype=self.store_dtype, device=dev)
        actions = torch.empty((T, E, A, env_cfg.action_dim), **f32)
        logps = torch.empty((T, E, A, 1), **f32)
        values = torch.empty((T + 1, E, 1), **f32)
        rewards = torch.empty((T, E, 1), **f32)
        masks = torch.ones((T + 1, E, 1), **f32)
        bad_masks = torch.ones((T + 1, E, 1), **f32)
        cover = torch.empty((T, E), **f32)
        for t in range(T):
            action, logp = self.act(ts, obs.reshape(E * A, -1), deterministic, gen)
            values[t] = self.value(ts, obs.reshape(E, -1))
            obs_buf[t] = obs
            actions[t] = action.reshape(E, A, -1)
            logps[t] = logp.reshape(E, A, 1)
            states, out = step_batch(env_cfg, states, actions[t])
            masks[t + 1] = 1.0 - (out.done | out.truncated).float()[:, None]
            bad_masks[t + 1] = 1.0 - out.truncated.float()[:, None]
            rewards[t] = out.reward[:, None]
            cover[t] = out.coverage_rate
            obs = out.obs
        obs_buf[T] = obs
        values[T] = self.value(ts, obs.reshape(E, -1))
        return Trajectory(obs_buf, actions, logps, values, rewards, masks, cover, bad_masks)

    # ------------------------------------------------------------------
    # returns / advantages
    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_returns(self, ts: TrainState, traj: Trajectory):
        cfg = self.cfg
        values = self._denorm(ts, traj.values)
        bad = traj.bad_masks if cfg.use_proper_time_limits else None
        if cfg.use_gae:
            if bad is None and self.gae_kernel:
                return compute_gae_cuda(traj.rewards, values, traj.masks, cfg.gamma,
                                        cfg.gae_lambda)
            return compute_gae(traj.rewards, values, traj.masks, cfg.gamma,
                               cfg.gae_lambda, bad_masks=bad)
        returns = discounted_returns(
            traj.rewards, values[-1], traj.masks, cfg.gamma, bad_masks=bad,
            values=values[:-1] if bad is not None else None,
        )
        return returns - values[:-1], returns

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def update(self, ts: TrainState, traj: Trajectory, adv, returns):
        """``ppo_epoch`` PPO epochs; returns the epoch-mean metrics tensor
        [value_loss, policy_loss, dist_entropy, actor_grad_norm,
        critic_grad_norm, ratio]."""
        T, E, A, _ = traj.actions.shape
        adv_n = normalize_advantages(adv)
        if self.fused_loss:
            m = self._update_fused_full(ts, traj, adv_n, returns)
        else:
            net_in = lambda x: x.to(self.net_dtype)
            batch = (
                net_in(traj.obs[:-1]),
                traj.actions,
                traj.log_probs,
                adv_n[:, :, None, :].expand(T, E, A, 1),
                net_in(traj.obs[:-1].reshape(T, E, A * self.obs_dim)),
                traj.values[:-1],
                returns,
            )
            m = torch.stack([self._ff_minibatch_update(ts, batch)
                             for _ in range(self.cfg.ppo_epoch)]).mean(dim=0)
        ts.iteration += 1
        return m

    def _step(self, ts: TrainState):
        """Clip both networks' gradients and take one optimizer step each at
        the scheduled LR; returns (actor_norm, critic_norm) before clipping."""
        cfg = self.cfg
        norms = []
        for net, opt, base in ((ts.actor, ts.actor_opt, cfg.actor_lr),
                               (ts.critic, ts.critic_opt, cfg.critic_lr)):
            params = list(net.parameters())
            if cfg.use_max_grad_norm:
                norms.append(clip_by_global_norm_(params, cfg.max_grad_norm))
            else:
                norms.append(global_norm(p.grad for p in params))
            for group in opt.param_groups:
                group["lr"] = self.lr_at(base, ts.update_count)
            opt.step()
        ts.update_count += 1
        return norms

    def _ff_minibatch_update(self, ts: TrainState, batch):
        """One optimizer step by autograd of the plain PPO loss."""
        cfg = self.cfg
        obs_b, act_b, logp_b, adv_b, cent_b, vpred_b, ret_b = batch
        if cfg.use_valuenorm:
            ts.vnorm = VN.update(ts.vnorm, ret_b)
            ret_target = VN.normalize(ts.vnorm, ret_b)
        else:
            ret_target = ret_b

        mean, log_std = ts.actor(obs_b)
        new_logp = D.normal_log_prob(mean, log_std, act_b)
        dist_entropy = D.normal_entropy(log_std, mean).sum(-1).mean()
        ratio = torch.exp(new_logp - logp_b)
        surr1 = ratio * adv_b
        surr2 = jnp_clip(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv_b
        policy_loss = -torch.sum(torch.minimum(surr1, surr2), dim=-1, keepdim=True).mean()

        values = ts.critic(cent_b)
        v_clip = vpred_b + jnp_clip(values - vpred_b, -cfg.clip_param, cfg.clip_param)
        err, err_c = ret_target - values, ret_target - v_clip
        lf = (lambda e: FP.huber(e, cfg.huber_delta)) if cfg.use_huber_loss else _mse
        if cfg.use_clipped_value_loss:
            value_loss = torch.maximum(lf(err), lf(err_c)).mean()
        else:
            value_loss = lf(err).mean()

        total = (policy_loss - dist_entropy * cfg.entropy_coef
                 + value_loss * cfg.value_loss_coef)
        ts.actor_opt.zero_grad(set_to_none=False)
        ts.critic_opt.zero_grad(set_to_none=False)
        total.backward()
        a_norm, c_norm = self._step(ts)
        return torch.stack([value_loss.detach(), policy_loss.detach(),
                            dist_entropy.detach(), a_norm, c_norm,
                            ratio.detach().mean()])

    def _norm_seq(self, ts: TrainState, returns):
        """Per-epoch (shift, scale) of the value normalizer for the fused
        epochs: the stats update runs BEFORE normalizing, once per epoch on
        the same returns, so the sequence is independent of the epoch
        bodies. Returns ((ppo_epoch, 2) tensor, final vnorm)."""
        n = self.cfg.ppo_epoch
        if not self.cfg.use_valuenorm:
            one = torch.tensor([0.0, 1.0], dtype=torch.float32, device=self.device)
            return one.expand(n, 2), ts.vnorm
        vn, rows = ts.vnorm, []
        for _ in range(n):
            vn = VN.update(vn, returns)
            mean, var = VN.stats(vn)
            rows.append(torch.cat([mean, torch.sqrt(var)]).float())
        return torch.stack(rows), vn

    @torch.no_grad()
    def _update_fused_full(self, ts: TrainState, traj: Trajectory, adv_n, returns):
        """Fused-loss epochs: rows and packed aux built once; the critic's
        team-concat rows are a reshape of the same obs buffer."""
        T, E, A, _ = traj.actions.shape
        R, Rv = T * E * A, T * E
        obs_in = traj.obs[:-1].to(self.net_dtype)
        obs_rows = obs_in.reshape(R, self.obs_dim)
        cent_rows = obs_in.reshape(Rv, A * self.obs_dim)
        aux_a = FP.pack_actor_aux(
            traj.actions.reshape(R, -1),
            traj.log_probs.reshape(R, -1),
            adv_n[:, :, None, :].expand(T, E, A, 1).reshape(R, 1),
        )
        aux_c = FP.pack_critic_aux(traj.values[:-1].reshape(Rv, 1), returns.reshape(Rv, 1))
        seq, vnorm = self._norm_seq(ts, returns)
        metrics = [
            self._fused_core(ts, obs_rows, aux_a, cent_rows, aux_c, seq[e].contiguous(), R, Rv)
            for e in range(self.cfg.ppo_epoch)
        ]
        ts.vnorm = vnorm
        return torch.stack(metrics).mean(dim=0)

    def _fused_core(self, ts: TrainState, obs_rows, aux_a, cent_rows, aux_c, norm,
                    n_a: int, n_c: int):
        """Both kernels on the packed rows, mean-loss gradients into
        ``.grad``, one optimizer step each; returns the six metrics."""
        cfg = self.cfg
        common = dict(
            n_layers=cfg.layer_n + 1,
            use_feature_norm=cfg.use_feature_normalization,
            use_relu=cfg.use_relu,
            bf16=self.bf16,
            clip_param=cfg.clip_param,
            fold=cfg.fused_fold,
        )
        actor, critic = ts.actor, ts.critic
        tg_a, dwh, dbh, dls, met_a = FP.actor_ppo_grads_packed(
            obs_rows, aux_a, actor.base.flat_params(), actor.act_out.weight.t(),
            actor.act_out.bias, actor.log_std, **common,
        )
        # the entropy bonus of the state-independent gaussian touches only
        # log_std: d(-coef * mean(entropy)) / dlog_std = -coef
        _set_grads(actor.base, tg_a, 1.0 / n_a)
        actor.act_out.weight.grad = dwh.t() / n_a
        actor.act_out.bias.grad = dbh / n_a
        actor.log_std.grad = dls / n_a - cfg.entropy_coef

        tg_c, dwv, dbv, met_c = FP.critic_value_grads_packed(
            cent_rows, aux_c, norm, critic.base.flat_params(), critic.v_out.weight.t(),
            critic.v_out.bias, huber_delta=cfg.huber_delta,
            use_huber=cfg.use_huber_loss, use_clipped=cfg.use_clipped_value_loss,
            **common,
        )
        cs = cfg.value_loss_coef / n_c
        _set_grads(critic.base, tg_c, cs)
        critic.v_out.weight.grad = dwv.t() * cs
        critic.v_out.bias.grad = dbv * cs

        # dist_entropy is the same for every row of the gaussian
        dist_entropy = torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + actor.log_std)
        a_norm, c_norm = self._step(ts)
        return torch.stack([met_c[0] / n_c, met_a[0] / n_a, dist_entropy, a_norm,
                            c_norm, met_a[1] / n_a])

    # ------------------------------------------------------------------
    # full iteration
    # ------------------------------------------------------------------
    def train_iteration(self, ts: TrainState, timer=None) -> Metrics:
        """Rollout -> GAE -> PPO epochs. With a
        :class:`~dcc_tpu_torch.utils.profiling.PhaseTimer`, each phase is
        timed to its end on the device."""

        def phase(name):
            if timer is None:
                return contextlib.nullcontext()
            return _synced(timer, name, self.device)

        with phase("rollout"):
            traj = self.rollout(ts, self.cfg.n_rollout_threads)
        with phase("returns"):
            adv, returns = self.compute_returns(ts, traj)
        with phase("update"):
            m = self.update(ts, traj, adv, returns)
        stats = torch.cat([
            traj.rewards.mean(dim=(1, 2)).sum().reshape(1),
            traj.coverage.max(dim=0).values.mean().reshape(1),
            m,
        ]).tolist()
        return Metrics(*stats)

    def eval_iteration(self, ts: TrainState, n_envs: int,
                       generator: Optional[torch.Generator] = None):
        """Eval rollout on the same sampling path as training."""
        traj = self.rollout(ts, n_envs, generator=generator)
        return {
            "reward": float(traj.rewards.mean(dim=(1, 2)).sum()),
            "coverage_rate": float(traj.coverage.max(dim=0).values.mean()),
        }


def _set_grads(base, tg, scale: float) -> None:
    """Kernel trunk grads (flat order of ``MLPBase.flat_params``) into the
    trunk's ``.grad``, scaled; Dense kernels are transposed to Linear."""
    i = 0
    if base.use_fn:
        base.feature_norm.weight.grad = tg[0] * scale
        base.feature_norm.bias.grad = tg[1] * scale
        i = 2
    for li in range(base.n_layers):
        fc, ln = getattr(base, f"fc{li}"), getattr(base, f"norm{li}")
        fc.weight.grad = (tg[i] * scale).t().contiguous()
        fc.bias.grad = tg[i + 1] * scale
        ln.weight.grad = tg[i + 2] * scale
        ln.bias.grad = tg[i + 3] * scale
        i += 4


@contextlib.contextmanager
def _synced(timer, name: str, device: torch.device):
    with timer.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
