"""MAPPO, shared-parameter or separated per agent, feed-forward or
recurrent, in PyTorch.

Counterpart of :mod:`dcc_tpu.algos.mappo`:
fresh-reset rollout over E batched envs -> value-normalizer-denormalized GAE
-> ``ppo_epoch`` PPO epochs of ``num_mini_batch`` minibatches (clipped
surrogate + clipped one-sided Huber value loss + entropy bonus, two Adams
with eps 1e-5, optax-style global-norm clip per network, count-based linear
LR decay). The value normalizer is ValueNorm or PopArt (which also rescales
the value head), or none. The actor's head follows the env's action mode
(gaussian, categorical, multi_discrete, multi_binary, mixed): actions are
stored (T, E, A, ``action_width``) and log-probs (T, E, A, k), k the
multi_discrete branch count and 1 otherwise.

``update`` dispatches as the JAX package's does:

* the recurrent policy: epochs on ``data_chunk_length`` chunk sequences
  with GRU warm starts, ``num_mini_batch`` random chunk subsets an epoch
  (``_update_recurrent``; ``use_naive_recurrent`` is the whole episode);
* ``update_chunks`` > 1 without the fused loss: one step an epoch, its
  gradient accumulated over row chunks (``_update_ff_chunked``);
* the fused loss with one minibatch: the kernels K3 / K4 (``fused_fold``)
  or K3u / K4u on rows packed once, each epoch's value-normalizer scalars
  from ``_norm_seq`` (``_update_fused_full``);
* separated per-agent policies (``share_policy=False``): each agent's own
  actor, critic, Adams and normalizer, updated on its own slice of the
  rollout with its own advantage normalization and permutations, through
  the shared path's minibatch step on the agent's own state
  (``_update_separated``);
* otherwise one step per minibatch: by autograd of the loss
  (``_minibatch_update``; with the fused trunk its backward is the K2b
  kernel, :class:`~dcc_tpu_torch.ops.fused_mlp.FusedTrunk`; ``use_remat``
  recomputes the forwards in the backward), or with the fused loss by the
  kernels on each gathered minibatch (``_fused_minibatch_update``).
  Minibatches are one permutation of the T*E*A rows an epoch, shared by
  every field, the remainder dropped.

Dispatch of the kernels mirrors ``MAPPO.__init__`` of the JAX package:
"auto" selects the GAE kernel K1 on CUDA, and the fused trunk K2 / K2b and
(feed-forward Gaussian policy only) the fused loss on CUDA in bf16; "on"
forces them (on CPU tensors that runs their plain versions). Separated
policies run K1 alone, on their (env, agent) columns, where the JAX package
keeps its scan; the fused trunk and loss need the shared policy, and
forcing either raises there. Options this
port does not run yet raise :class:`NotImplementedError` naming their
ROADMAP item (a rank-3 ``obs_shape``, whose CNN actor is A9), and so does
a run on CUDA whose rows are too wide for a row tile of a kernel it
launches (ROADMAP B2).

With a :class:`~dcc_tpu_torch.parallel.mesh.Mesh` (``mesh=``) the program
is data-parallel over its ranks, as the JAX package's over a device mesh:
each rank resets, steps and stores only its block of the envs
(``Mesh.rows``), runs K1 and K2 on its rows, and draws every random number
(action noise, a random reset, the minibatch permutations) at its global
shape from the generator every rank holds, keeping its rows, so that the
ranks together roll out as one process does. The parameters are
replicated: the fused update all-reduces K3 / K4's SUM accumulators before
it divides by the global row counts (JAX ``_update_fused_full_sharded``);
the autograd updates take each rank's sum over its rows of a minibatch
over the minibatch's global row count, and all-reduce ``.grad`` (with the
metrics) once a step, before the clip, so every rank takes the same step.
The advantage normalization, the value normalizer's statistics and the
metrics sum over the ranks. A forced kernel raises where JAX's raises
under a mesh; ``auto`` keeps every kernel on any mesh, each on its rank's
rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..envs import EnvConfig, get_scenario
from ..models import Actor, Critic
from ..models import distributions as D
from ..models import popart as PA
from ..models import valuenorm as VN
from ..ops import fused_mlp as FM
from ..ops import fused_ppo as FP
from ..ops import tiles
from ..ops.cuda_gae import compute_gae_cuda
from ..ops.gae import compute_gae, discounted_returns
from ..parallel import distributed
from ..parallel.mesh import Mesh, env_fns
from ..utils import clip_by_global_norm_, global_norm, resolve_device
from ..utils.profiling import timed_phase


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
    env_dtype: str = "float32"  # float32 | float64: the env's physics; networks stay f32
    store_obs_bf16: bool = True
    fused_loss: str = "auto"  # auto | on | off ("interpret" = on)


@dataclass
class TrainState:
    """Mutable training state: networks, both optimizers, the value
    normalizer (ValueNorm or PopArt), counters and the random generator of
    the rollout and the minibatch permutations.

    With separated policies (``share_policy=False``) ``agents`` holds one
    such state per agent, with the agent's own networks, optimizers and
    normalizer, this state's generator, and the shared ``update_count``,
    which each agent's update starts from; this state's own networks,
    optimizers and normalizers are then None."""

    actor: Optional[Actor]
    critic: Optional[Critic]
    actor_opt: Optional[torch.optim.Optimizer]
    critic_opt: Optional[torch.optim.Optimizer]
    vnorm: Optional[VN.ValueNormState]
    update_count: int  # optimizer steps taken (drives the LR schedule)
    iteration: int  # outer iterations finished
    generator: torch.Generator
    popart: Optional[PA.PopArtState] = None
    agents: Optional[List["TrainState"]] = None  # separated policies: agent i's state

    def policies(self) -> List["TrainState"]:
        """The states that hold networks: each agent's, or this one."""
        return self.agents or [self]


class Trajectory(NamedTuple):
    """Time-major rollout storage; rewards / masks are per env, values per
    env (shared policy) or per agent (separated policies)."""

    obs: torch.Tensor  # (T+1, E, A, D)
    actions: torch.Tensor  # (T, E, A, action_width)
    log_probs: torch.Tensor  # (T, E, A, k): k = branches for multi_discrete, else 1
    values: torch.Tensor  # (T+1, E, 1); separated: (T+1, E, A, 1)
    rewards: torch.Tensor  # (T, E, 1)
    masks: torch.Tensor  # (T+1, E, 1)
    coverage: torch.Tensor  # (T, E)
    bad_masks: torch.Tensor  # (T+1, E, 1)
    # recurrent policies only: the hidden state ENTERING each step (before
    # its mask reset), the chunk warm starts of the update
    actor_h: Optional[torch.Tensor] = None  # (T, E, A, recurrent_n, H)
    critic_h: Optional[torch.Tensor] = None  # (T, E, recurrent_n, H); separated: (T, E, A, ..)


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


def normalize_advantages(adv: torch.Tensor, dim=None, allsum=None, n=None) -> torch.Tensor:
    """(adv - mean) / (std + 1e-5) over all rows, or over the axes ``dim``
    (separated policies: (0, 1), each agent's (T, E)), with the POPULATION
    std in two passes, as ``jnp.std`` (``torch.std`` defaults to the
    unbiased one). Under a mesh ``allsum`` sums over the ranks and ``n`` is
    the global count of the reduced elements."""
    dims = tuple(range(adv.dim())) if dim is None else dim
    if n is None:
        n = math.prod(adv.shape[d] for d in dims)
    total = (lambda t: t) if allsum is None else allsum
    mean = total(adv.sum(dims, keepdim=True)) / n
    var = total(((adv - mean) ** 2).sum(dims, keepdim=True)) / n
    return (adv - mean) / (torch.sqrt(var) + 1e-5)


def _resolve_switch(value: str, name: str, auto: bool) -> bool:
    if value in ("on", "interpret"):
        return True
    if value == "off":
        return False
    if value == "auto":
        return auto
    raise ValueError(f"unknown {name} {value!r}")


class MAPPO:
    def __init__(self, cfg: MAPPOConfig, env_cfg: EnvConfig, device=None,
                 scenario: str = "coverage", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.env_cfg = env_cfg
        self.mesh = mesh
        self._allsum = None if mesh is None else mesh.all_sum  # a sum over the ranks
        self.device = resolve_device(mesh.device if device is None and mesh else device)
        # a rank-3 obs is an image, for which JAX builds a CNN actor
        # (dcc_tpu/algos/mappo.py:304-310); an MLP on the flattened obs
        # would train a different model
        obs_shape = tuple(getattr(env_cfg, "obs_shape", (env_cfg.obs_dim,)))
        if len(obs_shape) == 3:
            raise NotImplementedError(
                f"rank-3 obs_shape {obs_shape}: the CNN actor is not ported yet "
                f"(ROADMAP A9)")
        # scenario dispatch: the registry's functions (rollout's env_fns)
        self.scenario = scenario
        self._obs_fn = get_scenario(scenario)["observation"]
        if cfg.compute_dtype in ("bfloat16", "bf16"):
            self.bf16 = True
        elif cfg.compute_dtype in ("float32", "fp32", "f32"):
            self.bf16 = False
        else:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
        self.recurrent = cfg.use_recurrent_policy or cfg.use_naive_recurrent
        if cfg.use_popart and cfg.use_valuenorm:
            raise ValueError("use_popart and use_valuenorm are mutually exclusive")
        # the env's dtype: float64 runs the reference's f64 physics, on the
        # device (the GPU has native FP64), with f32 networks
        if cfg.env_dtype in ("float64", "f64", "fp64"):
            if scenario != "coverage":
                raise NotImplementedError(
                    "env_dtype='float64' is plumbed for the coverage "
                    "scenario's reset_batch only"
                )
            self.env_dtype = torch.float64
        elif cfg.env_dtype in ("float32", "fp32", "f32"):
            self.env_dtype = torch.float32
        else:
            raise ValueError(f"unknown env_dtype {cfg.env_dtype!r}")
        if not cfg.use_centralized_v:
            raise ValueError(
                "use_centralized_v=False: the critic is built on the team-concat "
                "observation, as in the JAX package's rollout"
            )

        if cfg.use_recurrent_policy and cfg.episode_length % cfg.data_chunk_length:
            # chunks must not straddle (env, agent) sequences
            raise ValueError(
                f"episode_length ({cfg.episode_length}) must be divisible by "
                f"data_chunk_length ({cfg.data_chunk_length})"
            )

        self.head_kind = env_cfg.action_head_kind
        self.head_dims = env_cfg.action_head_dims
        self.separated = not cfg.share_policy
        self.n_agents = env_cfg.n_agents
        on_cuda = self.device.type == "cuda"
        # a forced kernel raises where JAX's raises under a mesh
        # (dcc_tpu/algos/mappo.py:319-358, :505-535): its shard_map splits the
        # env axis evenly and takes no minibatches. The port's kernels run on
        # each rank's rows and its SUM accumulators are all-reduced, so
        # ``auto`` keeps every kernel on any mesh
        single = mesh is None or mesh.size == 1
        self._mesh_divides = single or mesh.divides(cfg.n_rollout_threads)
        if self.separated and cfg.fused_trunk in ("on", "interpret"):
            raise ValueError(
                "fused_trunk='on' requires share_policy=True (the separated path runs "
                "per-agent params over the trunk)"
            )
        if cfg.fused_trunk in ("on", "interpret") and not self._mesh_divides:
            raise ValueError(
                "fused_trunk='on' under a mesh needs n_rollout_threads divisible by the "
                "mesh size (the per-rank kernel splits the env axis evenly)")
        self.fused_trunk = _resolve_switch(
            cfg.fused_trunk, "fused_trunk", on_cuda and self.bf16 and not self.separated)
        fused_loss_ok = (not self.recurrent and not self.separated
                         and self.head_kind == "gaussian")
        if cfg.fused_loss in ("on", "interpret"):
            if not fused_loss_ok:
                raise ValueError(
                    "fused_loss requires the shared feed-forward gaussian policy (no "
                    "CNN/recurrent/separated/discrete)"
                )
            if not single and cfg.num_mini_batch != 1:
                raise ValueError(
                    "fused_loss under a multi-device mesh requires num_mini_batch=1 (the "
                    "per-rank path; minibatch permutations gather rows across the env "
                    "sharding)")
            if not self._mesh_divides:
                raise ValueError(
                    "fused_loss under a mesh needs n_rollout_threads divisible by the mesh "
                    "size")
        self.fused_loss = _resolve_switch(
            cfg.fused_loss, "fused_loss", on_cuda and self.bf16 and fused_loss_ok)
        if cfg.update_chunks > 1 and (self.recurrent or self.separated
                                      or cfg.num_mini_batch != 1):
            raise NotImplementedError(
                "update_chunks (gradient accumulation) supports the feed-forward "
                "shared-policy num_mini_batch=1 path"
            )
        if cfg.gae_backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown gae_backend {cfg.gae_backend!r}")
        # separated values (T+1, E, A, 1) go through K1 too: GAE is per
        # column, and the kernel takes their (env, agent) columns
        self.gae_kernel = cfg.gae_backend == "pallas" or (
            cfg.gae_backend == "auto" and on_cuda
        )
        self.obs_dim = env_cfg.obs_dim
        self.cent_obs_dim = env_cfg.share_obs_dim
        self.logp_cols = len(self.head_dims) if self.head_kind == "multi_discrete" else 1
        self.store_dtype = (
            torch.bfloat16 if self.bf16 and cfg.store_obs_bf16 else torch.float32
        )
        self.net_dtype = torch.bfloat16 if self.bf16 else torch.float32
        self._updates_per_iter = cfg.ppo_epoch * cfg.num_mini_batch
        if on_cuda and (self.fused_trunk or self.fused_loss):
            self._check_row_tiles()
        if mesh is not None and on_cuda and (self.gae_kernel or self.fused_trunk
                                             or self.fused_loss):
            # one nvcc a source on each host: its first rank builds, the
            # others wait and then load the libraries
            from ..ops import cuda_build

            distributed.local_first(cuda_build.build)

    def _fused_launches(self) -> list:
        """(kernel, row width, head width) of every fused kernel this run
        launches on CUDA."""
        act_n = self.env_cfg.action_dim
        launches = []
        if self.fused_trunk:
            launches += [("fused_mlp", self.obs_dim, 1), ("fused_mlp", self.cent_obs_dim, 1)]
            if not self.fused_loss:  # the update differentiates through K2b
                launches += [("fused_mlp_bwd", self.obs_dim, 1),
                             ("fused_mlp_bwd", self.cent_obs_dim, 1)]
        if self.fused_loss:
            tag = "" if self.cfg.fused_fold else "_unfolded"
            launches += [(f"actor_ppo_grads{tag}", self.obs_dim, act_n),
                         (f"critic_ppo_grads{tag}", self.cent_obs_dim, 1)]
        return launches

    def _check_row_tiles(self) -> None:
        """Raise where a fused kernel this run launches on CUDA has no row
        tile at its row width, before any launch: the f32 FMA kernels stage
        whole rows (one-row tiles up to 28,161 columns for the unfolded ones
        at hidden 256), and a row too wide would first fail inside its
        launch. In bf16 every width and depth has one (``ops.tiles.plan``):
        the kernels run their layers in column passes, stream their first
        layer in column chunks past the widest staged row, keep every layer's
        tile in device memory past the depth a block holds (the depth
        layout) and every tile as wide as the hidden layer past the widths
        one holds (the column-blocked layout)."""
        for kernel, width, n_head in self._fused_launches():
            if not tiles.plan(kernel, self.bf16, width, self.cfg.hidden_size,
                              self.cfg.layer_n + 1, n_head).tiles:
                raise NotImplementedError(
                    f"f32 {kernel} stages whole rows and no row tile fits one block's shared "
                    f"memory at {width}-wide rows; run in bf16 (--compute-dtype bfloat16), "
                    f"whose kernels take any width, or with the fused kernels off")

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
        to the device; with separated policies an ``nn.ModuleList`` of one
        per agent each (the actors first, from one generator)."""
        gen = torch.Generator().manual_seed(seed)
        rnn = dict(use_rnn=self.recurrent, recurrent_n=self.cfg.recurrent_n)
        make_actor = lambda: Actor(self.obs_dim, self.env_cfg.action_dim, self.cfg.gain,
                                   **rnn, head_kind=self.head_kind, head_dims=self.head_dims,
                                   **self._trunk_kwargs(gen))
        make_critic = lambda: Critic(self.cent_obs_dim, **rnn, **self._trunk_kwargs(gen))
        if self.separated:
            actor = nn.ModuleList(make_actor() for _ in range(self.n_agents))
            critic = nn.ModuleList(make_critic() for _ in range(self.n_agents))
        else:
            actor, critic = make_actor(), make_critic()
        return actor.to(self.device), critic.to(self.device)

    def _make_opt(self, params, lr: float) -> torch.optim.Optimizer:
        cfg = self.cfg
        if cfg.weight_decay:
            return torch.optim.AdamW(params, lr=lr, eps=cfg.opti_eps,
                                     weight_decay=cfg.weight_decay)
        return torch.optim.Adam(params, lr=lr, eps=cfg.opti_eps)

    def init_state(self, seed: int = 0, actor=None, critic=None) -> TrainState:
        """Fresh train state; ``actor`` / ``critic`` replace the seeded
        networks (e.g. with parameters converted from the JAX package; with
        separated policies, one of each per agent)."""
        if actor is None or critic is None:
            actor, critic = self.make_networks(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        if self.separated:
            agents = [self._policy_state(a, c, gen) for a, c in zip(actor, critic)]
            ts = TrainState(None, None, None, None, None, 0, 0, gen, agents=agents)
        else:
            ts = self._policy_state(actor, critic, gen)
        self.replicate(ts)
        return ts

    def replicate(self, ts: TrainState) -> None:
        """Under a mesh, every rank's parameters, normalizer statistics and
        Adam moments set to the coordinator's (after init and after a load);
        the generator is seeded alike on every rank. No-op without one."""
        if self.mesh is not None:
            for p in ts.policies():
                self.mesh.replicate_((p.actor, p.critic), (p.actor_opt, p.critic_opt),
                                     (*(p.vnorm or ()), *(p.popart or ())))

    def _policy_state(self, actor, critic, generator) -> TrainState:
        """A fresh state of one actor and critic: their Adams and
        normalizer, the counters at 0."""
        cfg = self.cfg
        if self.mesh is not None and self.bf16:
            # each rank's bf16 Dense gradients stay f32 partial sums until
            # _sync has added them (one process rounds the whole sum once)
            actor.defer_grad_rounding()
            critic.defer_grad_rounding()
        return TrainState(
            actor=actor,
            critic=critic,
            actor_opt=self._make_opt(actor.parameters(), cfg.actor_lr),
            critic_opt=self._make_opt(critic.parameters(), cfg.critic_lr),
            vnorm=VN.init(self.device) if cfg.use_valuenorm else None,
            update_count=0,
            iteration=0,
            generator=generator,
            popart=PA.init(device=self.device) if cfg.use_popart else None,
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
    def act(self, ts: TrainState, obs, deterministic: bool = False, generator=None,
            rnn_state=None, masks=None, rows=None):
        """obs (..., D) -> (action (..., action_width) f32, log_prob (..., k)),
        plus the new hidden state when ``rnn_state`` (B, L, H) and ``masks``
        (B, 1) are given. ``rows = (n, r)``: ``obs`` are the rows ``r`` of
        ``n``, whose noise is drawn for all ``n`` (a rank of a mesh)."""
        if rnn_state is None:
            return D.sample_head(self.head_kind, ts.actor(obs), deterministic, generator, rows)
        out, h = ts.actor(obs, rnn_state, masks)
        return (*D.sample_head(self.head_kind, out, deterministic, generator, rows), h)

    def value(self, ts: TrainState, cent_obs, rnn_state=None, masks=None):
        """The value (..., 1), plus the new hidden state when ``rnn_state``
        is given."""
        return ts.critic(cent_obs, rnn_state, masks)

    def _denorm(self, ts: TrainState, v):
        """Denormalized values; separated values (..., A, 1) with each
        agent's own normalizer state."""
        if ts.agents:
            return torch.stack([self._denorm(a, v[..., i, :]) for i, a in enumerate(ts.agents)],
                               dim=-2)
        if self.cfg.use_valuenorm:
            return VN.denormalize(ts.vnorm, v)
        if self.cfg.use_popart:
            return PA.denormalize(ts.popart, v)
        return v

    def _act_separated(self, agents, obs, cent, deterministic, gen, hidden=None, mask=None,
                       rows=None):
        """One rollout step of separated policies: agent ``i``'s actor on
        ``obs[:, i]``, its critic on the team-concat ``cent``, the agents in
        order from one generator. With ``hidden = (h_a, h_c)``, agent-major
        (A, E, L, H) stacks updated in place, every GRU takes the env
        ``mask``. ``rows``: the env rows of a rank (:meth:`act`). Returns
        actions (E, A, w), log-probs (E, A, k) and values (E, A, 1)."""
        outs = []
        for i, agent in enumerate(agents):
            if hidden is None:
                action, logp = self.act(agent, obs[:, i], deterministic, gen, rows=rows)
                value = self.value(agent, cent)
            else:
                h_a, h_c = hidden
                action, logp, h_a[i] = self.act(agent, obs[:, i], deterministic, gen, h_a[i],
                                                mask, rows)
                value, h_c[i] = self.value(agent, cent, h_c[i], mask)
            outs.append((action, logp, value))
        return tuple(torch.stack(x, dim=1) for x in zip(*outs))

    # ------------------------------------------------------------------
    # rollout
    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, ts: TrainState, n_envs: int, deterministic: bool = False,
                generator: Optional[torch.Generator] = None) -> Trajectory:
        """Fresh-reset rollout of episode_length steps over n_envs envs; the
        actions and a random env reset (``randomize_pois``, ``poi_speed``)
        draw from ``generator`` (default ``ts.generator``). The envs run in
        ``env_dtype`` on the device; observations reach the networks in f32
        and the trajectory in ``store_dtype``, rewards and coverage in f32.
        Under a mesh the trajectory holds this rank's block of the n_envs
        envs (``Mesh.rows``), its draws those of the whole rollout's."""
        cfg, env_cfg = self.cfg, self.env_cfg
        gen = ts.generator if generator is None else generator
        T, A = cfg.episode_length, env_cfg.n_agents
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        env_gen = gen if env_cfg.random_reset else None
        reset_batch, step_batch = env_fns(self.scenario, self.mesh, n_envs)
        E, draw = n_envs, None
        if self.mesh is not None:
            # this rank's envs, the draws made for all n_envs
            rows = self.mesh.rows(n_envs)
            E = rows.stop - rows.start
            draw = ((n_envs, rows) if self.separated
                    else (n_envs * A, slice(rows.start * A, rows.stop * A)))
        states = reset_batch(env_cfg, E, dtype=self.env_dtype, device=dev, generator=env_gen)
        obs = self._obs_fn(env_cfg, states).float()  # the env -> network boundary
        obs_buf = torch.empty((T + 1, E, A, self.obs_dim), dtype=self.store_dtype, device=dev)
        actions = torch.empty((T, E, A, env_cfg.action_width), **f32)
        logps = torch.empty((T, E, A, self.logp_cols), **f32)
        values = torch.empty((T + 1, E, A, 1) if self.separated else (T + 1, E, 1), **f32)
        rewards = torch.empty((T, E, 1), **f32)
        masks = torch.ones((T + 1, E, 1), **f32)
        bad_masks = torch.ones((T + 1, E, 1), **f32)
        cover = torch.empty((T, E), **f32)
        hid = None
        if self.recurrent and self.separated:
            # per-agent GRUs: agent-major hidden stacks
            L, H = cfg.recurrent_n, cfg.hidden_size
            h_a = torch.zeros((A, E, L, H), **f32)
            h_c = torch.zeros((A, E, L, H), **f32)
            hid = (torch.empty((T, E, A, L, H), **f32), torch.empty((T, E, A, L, H), **f32))
        elif self.recurrent:
            L, H = cfg.recurrent_n, cfg.hidden_size
            h_a = torch.zeros((E * A, L, H), **f32)
            h_c = torch.zeros((E, L, H), **f32)
            hid = (torch.empty((T, E, A, L, H), **f32), torch.empty((T, E, L, H), **f32))
        for t in range(T):
            flat_obs, cent = obs.reshape(E * A, -1), obs.reshape(E, -1)
            if self.separated:
                if self.recurrent:
                    hid[0][t] = h_a.transpose(0, 1)
                    hid[1][t] = h_c.transpose(0, 1)
                rnn = dict(hidden=(h_a, h_c), mask=masks[t]) if self.recurrent else {}
                action, logp, values[t] = self._act_separated(ts.agents, obs, cent,
                                                              deterministic, gen, rows=draw,
                                                              **rnn)
            elif self.recurrent:
                # stored: the hidden state entering step t, before its reset
                hid[0][t] = h_a.reshape(E, A, L, H)
                hid[1][t] = h_c
                agent_mask = masks[t][:, None, :].expand(E, A, 1).reshape(E * A, 1)
                action, logp, h_a = self.act(ts, flat_obs, deterministic, gen, h_a, agent_mask,
                                             draw)
                values[t], h_c = self.value(ts, cent, h_c, masks[t])
            else:
                action, logp = self.act(ts, flat_obs, deterministic, gen, rows=draw)
                values[t] = self.value(ts, cent)
            obs_buf[t] = obs
            actions[t] = action.reshape(E, A, -1)
            logps[t] = logp.reshape(E, A, -1)
            states, out = step_batch(env_cfg, states, actions[t], env_gen)
            masks[t + 1] = 1.0 - (out.done | out.truncated).float()[:, None]
            bad_masks[t + 1] = 1.0 - out.truncated.float()[:, None]
            rewards[t] = out.reward[:, None]
            cover[t] = out.coverage_rate
            obs = out.obs.float()
        obs_buf[T] = obs
        if self.separated:
            cent = obs.reshape(E, -1)
            values[T] = torch.stack([
                self.value(a, cent, h_c[i], masks[T])[0] if self.recurrent else self.value(a, cent)
                for i, a in enumerate(ts.agents)], dim=1)
        elif self.recurrent:
            values[T] = self.value(ts, obs.reshape(E, -1), h_c, masks[T])[0]
        else:
            values[T] = self.value(ts, obs.reshape(E, -1))
        return Trajectory(obs_buf, actions, logps, values, rewards, masks, cover, bad_masks,
                          *(hid or ()))

    # ------------------------------------------------------------------
    # returns / advantages
    # ------------------------------------------------------------------
    @torch.no_grad()
    def compute_returns(self, ts: TrainState, traj: Trajectory):
        cfg = self.cfg
        values = self._denorm(ts, traj.values)
        bad = traj.bad_masks if cfg.use_proper_time_limits else None
        rewards, masks = traj.rewards, traj.masks
        if self.separated:
            # per-agent values (T+1, E, A, 1) against per-env rewards and
            # masks: an explicit agent axis, so that the env axis of the
            # masks never pairs with the agent axis of the values (E == A)
            rewards, masks = rewards[:, :, None], masks[:, :, None]
            bad = None if bad is None else bad[:, :, None]
        if cfg.use_gae:
            # K1 on this rank's env columns: the recurrence never crosses
            # envs (JAX _gae_pallas_sharded); a forced kernel keeps JAX's rule
            if cfg.gae_backend == "pallas" and not self._mesh_divides:
                raise ValueError(
                    f"gae_backend='pallas' under a mesh needs the env count "
                    f"({cfg.n_rollout_threads}) divisible by the mesh size "
                    f"({self.mesh.size}); use 'auto' to fall back")
            if bad is None and self.gae_kernel:
                return compute_gae_cuda(rewards, values, masks, cfg.gamma, cfg.gae_lambda)
            return compute_gae(rewards, values, masks, cfg.gamma, cfg.gae_lambda,
                               bad_masks=bad)
        returns = discounted_returns(
            rewards, values[-1], masks, cfg.gamma, bad_masks=bad,
            values=values[:-1] if bad is not None else None,
        )
        return returns - values[:-1], returns

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def update(self, ts: TrainState, traj: Trajectory, adv, returns, perms=None,
               generator: Optional[torch.Generator] = None):
        """``ppo_epoch`` PPO epochs; returns the metrics tensor [value_loss,
        policy_loss, dist_entropy, actor_grad_norm, critic_grad_norm, ratio],
        the mean over epochs and minibatches.

        With ``num_mini_batch`` > 1 every epoch takes one permutation, of the
        T*E*A rows (feed-forward) or of the C chunks (recurrent), and uses
        its first ``mb * num_mini_batch`` entries, ``mb = n //
        num_mini_batch``. ``perms`` gives them, a (ppo_epoch, n) integer
        array as the JAX package draws them (``permutation(key_e, n)`` of
        each epoch's key); without it they are drawn from ``generator``
        (default ``ts.generator``). Separated policies take one such array
        per agent, (A, ppo_epoch, n) or (A, ppo_epoch, num_mini_batch, mb),
        of each agent's T*E rows or E*T/L chunks
        (:meth:`_update_separated`).

        Under a mesh ``traj``, ``adv`` and ``returns`` hold this rank's block
        of the ``n_rollout_threads`` envs, and ``perms`` index the rows or
        chunks of all of them: each rank takes those of its envs."""
        cfg = self.cfg
        T, E, A, _ = traj.actions.shape
        Eg = self._global_envs(E)
        gen = ts.generator if generator is None else generator
        if self.separated:
            m = self._update_separated(ts, traj,
                                       normalize_advantages(adv, (0, 1), self._allsum, T * Eg),
                                       returns, perms, gen, Eg)
            ts.iteration += 1
            return m
        adv_n = normalize_advantages(adv, None, self._allsum, T * Eg)
        if self.recurrent:
            m = self._update_recurrent(ts, traj, adv_n, returns, perms, gen, Eg)
        elif cfg.update_chunks > 1 and not self.fused_loss:
            # gradient accumulation bounds activation memory; the fused loss
            # materializes nothing (rows, hidden)-sized, so it ignores it
            m = self._update_ff_chunked(ts, traj, adv_n, returns, Eg)
        elif self.fused_loss and cfg.num_mini_batch == 1:
            m = self._update_fused_full(ts, traj, adv_n, returns, Eg)
        elif cfg.num_mini_batch == 1:
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
            n_rows = self._n_rows(T * Eg * A, T * Eg)
            m = torch.stack([self._minibatch_update(ts, batch, n_rows=n_rows)
                             for _ in range(cfg.ppo_epoch)]).mean(dim=0)
        else:
            rows = self._ff_rows(traj, adv_n, returns)
            step = self._fused_minibatch_update if self.fused_loss else self._minibatch_update
            mb = T * Eg * A // cfg.num_mini_batch
            m = torch.stack([step(ts, tuple(r[idx] for r in rows), n_rows=self._n_rows(mb, mb))
                             for idx in (self._owned(i, Eg, A) for i in
                                         self._minibatches(T * Eg * A, perms, gen))]).mean(dim=0)
        ts.iteration += 1
        return m

    def _global_envs(self, n_local: int) -> int:
        """The env count of the rollout an update takes: ``n_local``
        without a mesh; under one ``n_rollout_threads``, of which this rank
        must hold its block."""
        if self.mesh is None:
            return n_local
        n = self.cfg.n_rollout_threads
        rows = self.mesh.rows(n)
        if rows.stop - rows.start != n_local:
            raise ValueError(f"under a mesh the update takes this rank's "
                             f"{rows.stop - rows.start} of the {n} n_rollout_threads envs, "
                             f"not {n_local}")
        return n

    def _n_rows(self, n_actor: int, n_critic: int):
        """The global row counts of a step's actor and critic means under a
        mesh; None without one (the means over the rows at hand)."""
        return None if self.mesh is None else (n_actor, n_critic)

    def _owned(self, idx: torch.Tensor, n_envs: int, inner: int) -> torch.Tensor:
        """The local positions of this rank's entries of ``idx``, indices
        of a C-order index space (outer, ``n_envs``, ``inner``) of all the
        envs, in the same space over this rank's block of them (``idx``
        itself without a mesh)."""
        if self.mesh is None:
            return idx
        rows = self.mesh.rows(n_envs)
        outer, rest = idx // (n_envs * inner), idx % (n_envs * inner)
        env, i = rest // inner, rest % inner
        mine = (env >= rows.start) & (env < rows.stop)
        local = (outer * (rows.stop - rows.start) + env - rows.start) * inner + i
        return local[mine]

    def _minibatches(self, n: int, perms, generator):
        """Each epoch's minibatch indices in order: ``num_mini_batch`` rows of
        ``n // num_mini_batch`` from that epoch's permutation of ``n``."""
        nmb, epochs = self.cfg.num_mini_batch, self.cfg.ppo_epoch
        mb = n // nmb
        if perms is None:
            perms = [torch.randperm(n, generator=generator, device=generator.device)
                     for _ in range(epochs)]
        perms = torch.stack([torch.as_tensor(p).reshape(-1) for p in perms])
        perms = perms.to(self.device).long()
        if perms.shape[0] != epochs or perms.shape[1] < mb * nmb:
            raise ValueError(f"perms of shape {tuple(perms.shape)}: expected {epochs} "
                             f"permutations of {n}")
        return [idx for p in perms for idx in p[: mb * nmb].reshape(nmb, mb)]

    def _ff_rows(self, traj: Trajectory, adv_n, returns):
        """The trajectory as (T*E*A)-row fields in C order over (t, e, a), as
        the reference's feed-forward generator flattens its storage: the
        critic-side fields (team-concat obs, value predictions, returns) are
        the env rows duplicated per agent, so one permutation gathers every
        field. Returns (obs, actions, log_probs, adv, cent_obs, value_preds,
        returns)."""
        T, E, A, _ = traj.actions.shape
        B = T * E * A
        net_in = lambda x: x.to(self.net_dtype)
        per_agent = lambda x: x[:, :, None].expand(T, E, A, x.shape[-1]).reshape(B, -1)
        obs = traj.obs[:-1]
        return (
            net_in(obs.reshape(B, self.obs_dim)),
            traj.actions.reshape(B, -1),
            traj.log_probs.reshape(B, -1),
            per_agent(adv_n),
            net_in(per_agent(obs.reshape(T, E, A * self.obs_dim))),
            per_agent(traj.values[:-1]),
            per_agent(returns),
        )

    def _update_recurrent(self, ts: TrainState, traj: Trajectory, adv_n, returns, perms,
                          generator, n_envs: int):
        """PPO epochs on chunk sequences with hidden-state warm starts (JAX
        ``_update_recurrent``): the (T, E, A) rollout is cut in (env, agent,
        time) order into C chunks of L = ``data_chunk_length`` steps (L = T
        for ``use_naive_recurrent``), each GRU warm-started from the stored
        hidden state at its first step; critic rows are the env rows
        duplicated per agent, as in the reference's shared buffer. Each
        epoch's minibatches are ``num_mini_batch`` sets of C //
        ``num_mini_batch`` chunks from a permutation of the C chunks.

        With num_mini_batch=1 JAX's per-epoch chunk permutation only
        reorders the chunks inside full-batch means, so the chunks stay in
        order here and the result equals JAX's up to summation order. Under a
        mesh the chunks are those of all ``n_envs`` envs, each rank taking
        its envs' chunks of each minibatch."""
        cfg = self.cfg
        T, E, A, _ = traj.actions.shape
        L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
        K = T // L
        C = E * A * K
        if n_envs * A * K < cfg.num_mini_batch:
            raise ValueError(
                f"num_mini_batch ({cfg.num_mini_batch}) exceeds the number of data chunks "
                f"({n_envs * A * K})"
            )

        def chunks(x):
            """(T, E, A, ...) -> time-major chunks (L, C, ...)."""
            x = x.movedim(0, 2)
            return x.reshape(C, L, *x.shape[3:]).transpose(0, 1).contiguous()

        def per_agent(x):
            return x[:, :, None].expand(T, E, A, *x.shape[2:])

        def warm_starts(h):
            """(T, E, A, rec_n, H) -> the (C, rec_n, H) chunk firsts."""
            return h.movedim(0, 2)[:, :, ::L].reshape(C, *h.shape[3:])

        obs = traj.obs[:-1]  # as stored (bf16 in bf16 mode), as in JAX
        batch = (
            chunks(obs),
            chunks(traj.actions),
            chunks(traj.log_probs),
            chunks(per_agent(adv_n)),
            chunks(per_agent(obs.reshape(T, E, -1))),
            chunks(per_agent(traj.values[:-1])),
            chunks(per_agent(returns)),
        )
        rnn = (chunks(per_agent(traj.masks[:-1])), warm_starts(traj.actor_h),
               warm_starts(per_agent(traj.critic_h)))
        Cg = n_envs * A * K
        if cfg.num_mini_batch == 1:
            n_rows = self._n_rows(L * Cg, L * Cg)
            ms = [self._minibatch_update(ts, batch, rnn, n_rows) for _ in range(cfg.ppo_epoch)]
        else:
            mb = L * (Cg // cfg.num_mini_batch)
            ms = [self._minibatch_update(ts, tuple(x[:, idx] for x in batch),
                                         (rnn[0][:, idx], rnn[1][idx], rnn[2][idx]),
                                         self._n_rows(mb, mb))
                  for idx in (self._owned(i, n_envs, A * K)
                              for i in self._minibatches(Cg, perms, generator))]
        return torch.stack(ms).mean(dim=0)

    def _update_separated(self, ts: TrainState, traj: Trajectory, adv_n, returns, perms,
                          generator, n_envs: int):
        """Per-agent PPO updates with per-agent networks, optimizers and
        normalizers (JAX ``_update_separated``, the reference's make_algo +
        SeparatedReplayBuffer path): the agents in order, each on its own
        (T, E) slice of the rollout through :meth:`_one_agent_update`, with
        its advantages normalized over its own rows (``adv_n``). The
        critic's team-concat input is shared by every agent, never copied
        per agent. Returns the metrics averaged over agents."""
        cfg = self.cfg
        T, E, A, _ = traj.actions.shape
        cent = traj.obs[:-1].reshape(T, E, A * self.obs_dim).to(self.net_dtype)
        shared = dict(cent=cent, mask=traj.masks[:-1])
        if self.recurrent:
            L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
            # per-env time slices, the same layout for every agent
            shared = {k: _env_chunks(v, L) for k, v in shared.items()}
        ms = []
        for i, agent in enumerate(ts.agents):
            agent.update_count = ts.update_count  # the LR schedule's count
            ms.append(self._one_agent_update(agent, traj, i, adv_n, returns, shared,
                                             None if perms is None else perms[i], generator,
                                             n_envs))
        ts.update_count += cfg.ppo_epoch * cfg.num_mini_batch
        return torch.stack(ms).mean(dim=0)

    def _one_agent_update(self, agent: TrainState, traj: Trajectory, i: int, adv_n, returns,
                          shared, perms, generator, n_envs: int):
        """Agent ``i``'s epochs on its own (T, E) buffer (JAX
        ``_one_agent_update``), through the shared path's minibatch step on
        the agent's state. Feed-forward: the T*E rows, one minibatch (no
        permutation) or ``num_mini_batch`` from a permutation an epoch.
        Recurrent: C = E*T/L chunks of L = ``data_chunk_length`` steps (T for
        ``use_naive_recurrent``) in (env, time) order, each GRU warm-started
        from the stored hidden state at its first step; with one minibatch
        the chunks stay in order, which equals JAX's permuted order up to
        summation order. Under a mesh the rows or chunks are those of all
        ``n_envs`` envs, each rank taking its envs'. Returns the metrics'
        mean over the steps."""
        cfg = self.cfg
        T, E = traj.actions.shape[:2]
        net_in = lambda x: x.to(self.net_dtype)
        own = (net_in(traj.obs[:-1, :, i]), traj.actions[:, :, i], traj.log_probs[:, :, i],
               adv_n[:, :, i], traj.values[:-1, :, i], returns[:, :, i])
        if self.recurrent:
            L = cfg.data_chunk_length if cfg.use_recurrent_policy else T
            K = T // L
            C, Cg = E * K, n_envs * K
            if Cg < cfg.num_mini_batch:
                raise ValueError(f"num_mini_batch ({cfg.num_mini_batch}) exceeds the "
                                 f"per-agent data chunks ({Cg})")
            obs, act, logp, adv, vpred, ret = (_env_chunks(x, L) for x in own)
            batch = (obs, act, logp, adv, shared["cent"], vpred, ret)
            warm = lambda h: h[:, :, i].transpose(0, 1)[:, ::L].reshape(C, *h.shape[3:])
            rnn = (shared["mask"], warm(traj.actor_h), warm(traj.critic_h))
            if cfg.num_mini_batch == 1:
                n_rows = self._n_rows(L * Cg, L * Cg)
                ms = [self._minibatch_update(agent, batch, rnn, n_rows)
                      for _ in range(cfg.ppo_epoch)]
            else:
                mb = L * (Cg // cfg.num_mini_batch)
                ms = [self._minibatch_update(agent, tuple(x[:, idx] for x in batch),
                                             (rnn[0][:, idx], rnn[1][idx], rnn[2][idx]),
                                             self._n_rows(mb, mb))
                      for idx in (self._owned(j, n_envs, K)
                                  for j in self._minibatches(Cg, perms, generator))]
        else:
            B, Bg = T * E, T * n_envs
            obs, act, logp, adv, vpred, ret = (x.reshape(B, x.shape[-1]) for x in own)
            rows = (obs, act, logp, adv, shared["cent"].reshape(B, -1), vpred, ret)
            if cfg.num_mini_batch == 1:
                n_rows = self._n_rows(Bg, Bg)
                ms = [self._minibatch_update(agent, rows, n_rows=n_rows)
                      for _ in range(cfg.ppo_epoch)]
            else:
                mb = Bg // cfg.num_mini_batch
                ms = [self._minibatch_update(agent, tuple(r[idx] for r in rows),
                                             n_rows=self._n_rows(mb, mb))
                      for idx in (self._owned(j, n_envs, 1)
                                  for j in self._minibatches(Bg, perms, generator))]
        return torch.stack(ms).mean(dim=0)

    def _update_ff_chunked(self, ts: TrainState, traj: Trajectory, adv_n, returns,
                           n_envs: int):
        """One optimizer step an epoch, its gradient accumulated over
        ``update_chunks`` consecutive row chunks (JAX ``_update_ff_chunked``):
        the batch mean is the equal-weight mean of the chunk means, so it
        equals the one-pass gradient up to rounding, and peak activation
        memory is one chunk's. The value normalizer (ValueNorm or PopArt) is
        updated once an epoch from the full returns. Under a mesh each rank
        cuts its own rows into the chunks, each chunk's loss its sum over
        a chunk's share of the ``n_envs`` envs' rows."""
        cfg = self.cfg
        T, E, A, _ = traj.actions.shape
        C = cfg.update_chunks
        R, Rv = T * n_envs * A, T * n_envs
        if R % C or Rv % C:
            raise ValueError(f"update_chunks ({C}) must divide T*E*A ({R}) and T*E ({Rv})")
        net_in = lambda x: x.to(self.net_dtype)
        obs = traj.obs[:-1]
        chunks = list(zip(*(x.tensor_split(C) for x in (
            net_in(obs.reshape(-1, self.obs_dim)),
            traj.actions.reshape(T * E * A, -1),
            traj.log_probs.reshape(T * E * A, -1),
            adv_n[:, :, None, :].expand(T, E, A, 1).reshape(-1, 1),
            net_in(obs.reshape(-1, A * self.obs_dim)),
            traj.values[:-1].reshape(-1, 1),
            returns.reshape(-1, 1),
        ))))
        n_rows = self._n_rows(R // C, Rv // C)
        params = [*ts.actor.parameters(), *ts.critic.parameters()]
        ms = []
        for _ in range(cfg.ppo_epoch):
            norm = self._update_normalizer(ts, returns, Rv)
            ts.actor_opt.zero_grad(set_to_none=False)
            ts.critic_opt.zero_grad(set_to_none=False)
            m_sum = 0.0
            for chunk in chunks:
                total, *m = self._ppo_loss(ts, chunk, norm(chunk[6]), n_rows=n_rows)
                total.backward()
                m_sum = m_sum + torch.stack([t.detach() for t in m])
            with torch.no_grad():
                for p in params:
                    p.grad.div_(C)
            m = self._sync(ts, m_sum / C)
            a_norm, c_norm = self._step(ts)
            ms.append(torch.stack([m[0], m[1], m[2], a_norm, c_norm, m[3]]))
        return torch.stack(ms).mean(dim=0)

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

    def _sync(self, ts: TrainState, partials: torch.Tensor) -> torch.Tensor:
        """Under a mesh, both networks' ``.grad`` and a step's metric
        ``partials`` (this rank's shares of the means) summed over the
        ranks in one collective, before the clip; returns the metrics.
        In bf16 the Dense layers' gradients, summed unrounded, are then
        rounded to bf16, as one process's autograd rounds its sum over all
        rows (``defer_grad_rounding``); rounding each rank's share instead
        would move the steps apart from one process's. No-op without a
        mesh."""
        if self.mesh is not None:
            grads = [p.grad for net in (ts.actor, ts.critic) for p in net.parameters()
                     if p.grad is not None]
            self.mesh.all_sum_([*grads, partials])
            with torch.no_grad():
                for net in (ts.actor, ts.critic):
                    if net.defer_grad_round:
                        for p in net.dense_params():
                            if p.grad is not None:
                                p.grad.copy_(FM.bf16_round(p.grad))
        return partials

    def _update_normalizer(self, ts: TrainState, ret, n=None):
        """Update the value normalizer on ``ret`` BEFORE normalizing (the
        reference's order); PopArt also rescales the value head in place,
        under no_grad, leaving Adam's moments as they are, as the JAX package
        does. Under a mesh the statistics are those of the ``n`` rows of all
        ranks. Returns the function that normalizes returns with the new
        statistics."""
        cfg = self.cfg
        if cfg.use_valuenorm:
            st = ts.vnorm = VN.update(ts.vnorm, ret, self._allsum, n)
            return lambda r: VN.normalize(st, r)
        if cfg.use_popart:
            head = ts.critic.v_out
            with torch.no_grad():
                ts.popart, kernel, bias = PA.update(ts.popart, head.weight, head.bias, ret,
                                                    self._allsum, n)
                head.weight.copy_(kernel)
                head.bias.copy_(bias)
            st = ts.popart
            return lambda r: PA.normalize(st, r)
        return lambda r: r

    def _ppo_loss(self, ts: TrainState, batch, ret_target, rnn=None, n_rows=None):
        """The PPO loss of one minibatch of feed-forward rows, or with ``rnn
        = (masks, actor warm starts, critic warm starts)`` of (L, C, .) chunk
        sequences (JAX ``_seq_minibatch_update``). With ``use_remat`` the
        feed-forward actor and critic recompute their forwards in the
        backward (``torch.utils.checkpoint``, where JAX has
        ``jax.checkpoint``). Returns (total, value_loss, policy_loss,
        dist_entropy, mean ratio); with ``n_rows = (actor rows, critic
        rows)`` of the minibatch over every rank, each mean is this rank's
        sum over its rows divided by them (its share of the global mean)."""
        cfg = self.cfg
        n_a, n_c = n_rows or (None, None)

        def mean(x, n, width=1):
            return x.mean() if n is None else x.sum() / (n * width)

        obs_b, act_b, logp_b, adv_b, cent_b, vpred_b, _ = batch
        if rnn is not None:
            mask_b, ha_b, hc_b = rnn
            out, _ = ts.actor.sequence(obs_b, ha_b, mask_b)
            values, _ = ts.critic.sequence(cent_b, hc_b, mask_b)
        elif cfg.use_remat:
            out = checkpoint(ts.actor, obs_b, use_reentrant=False)
            values = checkpoint(ts.critic, cent_b, use_reentrant=False)
        else:
            out = ts.actor(obs_b)
            values = ts.critic(cent_b)
        # log-probs (rows, k) against adv (rows, 1): the ratio, clip and min
        # broadcast over the k columns, which the surrogate sums
        new_logp, ent = D.evaluate_head(self.head_kind, out, act_b)
        dist_entropy = mean(ent.sum(-1), n_a)
        ratio = torch.exp(new_logp - logp_b)
        surr1 = ratio * adv_b
        surr2 = jnp_clip(ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param) * adv_b
        policy_loss = -mean(torch.sum(torch.minimum(surr1, surr2), dim=-1, keepdim=True), n_a)

        v_clip = vpred_b + jnp_clip(values - vpred_b, -cfg.clip_param, cfg.clip_param)
        err, err_c = ret_target - values, ret_target - v_clip
        lf = (lambda e: FP.huber(e, cfg.huber_delta)) if cfg.use_huber_loss else _mse
        if cfg.use_clipped_value_loss:
            value_loss = mean(torch.maximum(lf(err), lf(err_c)), n_c)
        else:
            value_loss = mean(lf(err), n_c)

        total = (policy_loss - dist_entropy * cfg.entropy_coef
                 + value_loss * cfg.value_loss_coef)
        return total, value_loss, policy_loss, dist_entropy, mean(ratio, n_a, ratio.shape[-1])

    def _minibatch_update(self, ts: TrainState, batch, rnn=None, n_rows=None):
        """One optimizer step by autograd of the PPO loss (``_ppo_loss``),
        the value normalizer updated first on the minibatch's returns;
        under a mesh (``n_rows``) the gradients and metrics summed over the
        ranks first (``_sync``). Returns the six metrics."""
        ret_target = self._update_normalizer(ts, batch[6], n_rows and n_rows[1])(batch[6])
        total, *m = self._ppo_loss(ts, batch, ret_target, rnn, n_rows)
        ts.actor_opt.zero_grad(set_to_none=False)
        ts.critic_opt.zero_grad(set_to_none=False)
        total.backward()
        value_loss, policy_loss, dist_entropy, ratio = self._sync(
            ts, torch.stack([t.detach() for t in m]))
        a_norm, c_norm = self._step(ts)
        return torch.stack([value_loss, policy_loss, dist_entropy, a_norm, c_norm, ratio])

    def _norm_seq(self, ts: TrainState, returns, n_rows=None):
        """Per-epoch value-normalizer rows [kscale, bshift, shift, scale] of
        the fused one-minibatch epochs: (kscale, bshift) rescale the PopArt
        head (identity otherwise), (shift, scale) normalize the raw returns
        inside the critic kernel. The statistics update runs BEFORE
        normalizing, once per epoch on the same returns, so the sequence is
        independent of the epoch bodies; under a mesh the statistics are
        those of the ``n_rows`` rows of all ranks. Returns ((ppo_epoch, 4) tensor,
        final vnorm, final popart)."""
        cfg, n = self.cfg, self.cfg.ppo_epoch
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        zero = torch.zeros(1, dtype=torch.float32, device=self.device)
        rows = []
        if cfg.use_valuenorm:
            vn = ts.vnorm
            for _ in range(n):
                vn = VN.update(vn, returns, self._allsum, n_rows)
                mean, var = VN.stats(vn)
                rows.append(torch.cat([one, zero, mean, torch.sqrt(var)]).float())
            return torch.stack(rows), vn, ts.popart
        if cfg.use_popart:
            # PA.update on a (1, 0) head gives the rescale's coefficients:
            # kscale = old_std / new_std, bshift = (old_mean - new_mean) / new_std
            pa = ts.popart
            for _ in range(n):
                pa, kscale, bshift = PA.update(pa, one, zero, returns, self._allsum, n_rows)
                mean, var = PA.debiased(pa)
                rows.append(torch.cat([kscale, bshift, mean, torch.sqrt(var)]).float())
            return torch.stack(rows), ts.vnorm, pa
        return torch.cat([one, zero, zero, one]).expand(n, 4), ts.vnorm, ts.popart

    @torch.no_grad()
    def _update_fused_full(self, ts: TrainState, traj: Trajectory, adv_n, returns,
                           n_envs: int):
        """Fused-loss epochs on one minibatch: rows and packed aux built
        once; the critic's team-concat rows are a reshape of the same obs
        buffer. Each epoch applies its row of ``_norm_seq``: the PopArt head
        rescale before the kernels (JAX ``_fused_epoch_body``), the
        normalizer's (shift, scale) inside the critic kernel. Under a mesh
        (JAX ``_update_fused_full_sharded``) the kernels run on this rank's
        rows and the means are over the ``n_envs`` envs' rows."""
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
        seq, vnorm, popart = self._norm_seq(ts, returns, T * n_envs)
        metrics = []
        for e in range(self.cfg.ppo_epoch):
            if self.cfg.use_popart:
                head = ts.critic.v_out
                head.weight.mul_(seq[e, 0])
                head.bias.mul_(seq[e, 0]).add_(seq[e, 1])
            metrics.append(self._fused_core(ts, obs_rows, aux_a, cent_rows, aux_c,
                                            seq[e, 2:4].contiguous(), T * n_envs * A,
                                            T * n_envs))
        ts.vnorm, ts.popart = vnorm, popart
        return torch.stack(metrics).mean(dim=0)

    @torch.no_grad()
    def _fused_minibatch_update(self, ts: TrainState, mb, n_rows=None):
        """One optimizer step by the fused kernels on a gathered minibatch of
        rows (JAX ``_fused_minibatch_update``): the value normalizer is
        updated and applied to the returns first, so the critic kernel takes
        ``norm = [0, 1]``, and the aux rows are packed on every call. Under a
        mesh ``mb`` holds this rank's rows of the minibatch and ``n_rows``
        its global row counts."""
        obs_b, act_b, logp_b, adv_b, cent_b, vpred_b, ret_b = mb
        n_a, n_c = n_rows or (obs_b.shape[0], cent_b.shape[0])
        ret_target = self._update_normalizer(ts, ret_b, n_c)(ret_b)
        norm = torch.tensor([0.0, 1.0], dtype=torch.float32, device=self.device)
        return self._fused_core(ts, obs_b.contiguous(), FP.pack_actor_aux(act_b, logp_b, adv_b),
                                cent_b.contiguous(), FP.pack_critic_aux(vpred_b, ret_target),
                                norm, n_a, n_c)

    def _fused_core(self, ts: TrainState, obs_rows, aux_a, cent_rows, aux_c, norm,
                    n_a: int, n_c: int):
        """Both kernels (K3 / K4 with ``fused_fold``, else K3u / K4u) on the
        packed rows, mean-loss gradients into ``.grad``, one optimizer step
        each; returns the six metrics. Under a mesh the kernels' SUM
        accumulators are summed over the ranks (JAX's psum,
        dcc_tpu/algos/mappo.py:1636-1662) before the divide by the global
        row counts ``n_a``, ``n_c``."""
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
        if obs_rows.shape[0] == 0:
            # a rank that holds no row of a minibatch adds nothing to the sums
            # (contiguous, as the kernels' sums are: the same gradients in other
            # strides stepped the ranks' parameters apart by an ulp)
            zeros = lambda *xs: [x.new_zeros(x.shape, dtype=torch.float32) for x in xs]
            *tg_a, dwh, dbh, dls, met_a = zeros(*actor.base.flat_params(),
                                               actor.act_out.weight.t(), actor.act_out.bias,
                                               actor.log_std, obs_rows.new_empty(2))
            *tg_c, dwv, dbv, met_c = zeros(*critic.base.flat_params(), critic.v_out.weight.t(),
                                           critic.v_out.bias, obs_rows.new_empty(1))
        else:
            tg_a, dwh, dbh, dls, met_a = FP.actor_ppo_grads_packed(
                obs_rows, aux_a, actor.base.flat_params(), actor.act_out.weight.t(),
                actor.act_out.bias, actor.log_std, **common,
            )
            tg_c, dwv, dbv, met_c = FP.critic_value_grads_packed(
                cent_rows, aux_c, norm, critic.base.flat_params(), critic.v_out.weight.t(),
                critic.v_out.bias, huber_delta=cfg.huber_delta,
                use_huber=cfg.use_huber_loss, use_clipped=cfg.use_clipped_value_loss,
                **common,
            )
        if self.mesh is not None:
            self.mesh.all_sum_([*tg_a, dwh, dbh, dls, met_a, *tg_c, dwv, dbv, met_c])
        # the entropy bonus of the state-independent gaussian touches only
        # log_std: d(-coef * mean(entropy)) / dlog_std = -coef, added after
        # the sum over the ranks so that it counts once
        _set_grads(actor.base, tg_a, 1.0 / n_a)
        actor.act_out.weight.grad = dwh.t() / n_a
        actor.act_out.bias.grad = dbh / n_a
        actor.log_std.grad = dls / n_a - cfg.entropy_coef

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
    def _iteration(self, ts: TrainState, generator=None, timer=None) -> torch.Tensor:
        """Rollout -> GAE -> PPO epochs, with random numbers from
        ``generator`` (default ``ts.generator``); returns the iteration's
        eight metrics as one tensor on the device, with no host
        synchronisation. With a
        :class:`~dcc_tpu_torch.utils.profiling.PhaseTimer`, each phase is
        timed to its end on the device."""

        gen = ts.generator if generator is None else generator
        with timed_phase(timer, "rollout", self.device):
            traj = self.rollout(ts, self.cfg.n_rollout_threads, generator=gen)
        with timed_phase(timer, "returns", self.device):
            adv, returns = self.compute_returns(ts, traj)
        with timed_phase(timer, "update", self.device):
            m = self.update(ts, traj, adv, returns, generator=gen)
        return torch.cat([self.episode_metrics(traj, self.cfg.n_rollout_threads), m])

    def episode_metrics(self, traj: Trajectory, n_envs: int) -> torch.Tensor:
        """[reward, coverage_rate] of a rollout of ``n_envs`` envs: the sum
        over steps of the mean reward over the envs, and the mean over the
        envs of each env's best coverage; under a mesh over every rank's
        envs (one collective)."""
        sums = torch.cat([traj.rewards.sum(dim=(1, 2)),
                          traj.coverage.max(dim=0).values.sum().reshape(1)])
        if self.mesh is not None:
            sums = self.mesh.all_sum(sums)
        means = sums / n_envs
        return torch.stack([means[:-1].sum(), means[-1]])

    def train_iteration(self, ts: TrainState, timer=None) -> Metrics:
        """One outer iteration (``_iteration``); returns its metrics as
        floats."""
        return Metrics(*self._iteration(ts, timer=timer).tolist())

    def train_many(self, ts: TrainState, n_iters: int,
                   generator: Optional[torch.Generator] = None) -> Metrics:
        """``n_iters`` iterations in a row with no host synchronisation
        between them (JAX ``train_many``, its scan of ``train_iteration``);
        returns :class:`Metrics` whose fields are the per-iteration values
        stacked, (n_iters,) tensors on the device."""
        m = torch.stack([self._iteration(ts, generator) for _ in range(n_iters)])
        return Metrics(*m.unbind(dim=1))

    def eval_iteration(self, ts: TrainState, n_envs: int,
                       generator: Optional[torch.Generator] = None):
        """Eval rollout on the same sampling path as training (under a mesh
        each rank rolls its block of the ``n_envs`` envs)."""
        traj = self.rollout(ts, n_envs, generator=generator)
        reward, coverage = self.episode_metrics(traj, n_envs).tolist()
        return {"reward": reward, "coverage_rate": coverage}


def _env_chunks(x: torch.Tensor, L: int) -> torch.Tensor:
    """(T, E, ...) -> time-major chunks (L, C, ...), C = E*T/L, in (env,
    time) order: the separated buffer's chunking of one agent's data."""
    x = x.transpose(0, 1)
    return x.reshape(-1, L, *x.shape[2:]).transpose(0, 1).contiguous()


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

