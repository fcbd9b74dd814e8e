"""MADDPG of the port against ``dcc_tpu.algos.MADDPG`` on the same inputs.

Small shapes: 3 UAVs and 6 PoIs (obs 38, critic input 120), 2 envs, a
16-row buffer that wraps, batch 8, hidden (8,). The port's networks load
JAX's stacked parameters through ``compat.rlkit_flax_to_state_dict``; its
``collect`` takes the OU noise and warm-up actions JAX draws from the same
keys, and its updates take JAX's buffer indices. Tolerances (f32): 1e-5
relative and 1e-6 absolute for one update's losses, parameters, targets and
Adam moments, and for the collected transitions; the same bounds hold three
updates of a ``train_iteration``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dcc_tpu.algos import MADDPG as JMADDPG
from dcc_tpu.algos import MADDPGConfig as JMADDPGConfig
from dcc_tpu.configs.loader import load_yaml_merged as j_load_yaml_merged
from dcc_tpu.configs.loader import to_maddpg_config as j_to_maddpg_config
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MADDPG, MADDPGConfig, MAPPO, make_algo
from dcc_tpu_torch.compat import rlkit_flax_to_state_dict, state_dict_to_rlkit_flax
from dcc_tpu_torch.configs.loader import load as load_config
from dcc_tpu_torch.configs.loader import load_yaml_merged, to_maddpg_config
from dcc_tpu_torch.envs import EnvConfig, EnvState
from dcc_tpu_torch.runtime import checkpoint as ckpt
from dcc_tpu_torch.runtime.learner import Learner

RTOL, ATOL = 1e-5, 1e-6
ENV = dict(n_agents=3, n_pois=6)
CFG = dict(n_envs=2, steps_per_iter=6, updates_per_iter=3, batch_size=8, buffer_capacity=16,
           warmup_steps=4, hidden_sizes=(8,))
NETS = ("actor", "critic", "target_actor", "target_critic")
JNETS = dict(actor="actor_params", critic="critic_params", target_actor="target_actor_params",
             target_critic="target_critic_params")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy() if torch.is_tensor(got) else got,
                               _np(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """JAX's MADDPG with its jitted functions and its initial state, and
    the port's on the CPU with the same config."""
    jalgo = JMADDPG(JMADDPGConfig(**CFG), JEnvConfig(**ENV))
    fns = dict(
        init=jax.jit(jalgo.init_state)(jax.random.PRNGKey(0)),
        collect=jax.jit(lambda s, k, n: jalgo.collect(s, k, n), static_argnums=2),
        update=jax.jit(jalgo.update_once),
        train=jax.jit(jalgo.train_iteration),
        eval=jax.jit(lambda s, k: jalgo.eval_iteration(s, k, 2)),
        actors=jax.jit(jalgo._actors),
    )
    return jalgo, fns, MADDPG(MADDPGConfig(**CFG), EnvConfig(**ENV), device="cpu")


def _net(algo, flax_tree, actor: bool):
    net = algo.make_networks()[0 if actor else 1]
    net.load_state_dict(rlkit_flax_to_state_dict(_np_tree(flax_tree)))
    return net


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_state(algo, jst):
    """The port's state holding every field of JAX's state ``jst``
    (fresh Adams, as after JAX's ``init_state``)."""
    st = algo.init_state(actor=_net(algo, jst.actor_params, True),
                         critic=_net(algo, jst.critic_params, False))
    with torch.no_grad():
        for net in ("target_actor", "target_critic"):
            getattr(st, net).load_state_dict(
                rlkit_flax_to_state_dict(_np_tree(getattr(jst, JNETS[net]))))
    t = lambda x: torch.tensor(_np(x))
    buf = jst.buffer
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        getattr(st.buffer, k).copy_(t(getattr(buf, k)))
    st.buffer.ptr, st.buffer.size = int(buf.ptr), int(buf.size)
    s = jst.env_states
    st.env_states = EnvState(pos=t(s.pos), vel=t(s.vel), poi_pos=t(s.poi_pos),
                             poi_vel=t(s.poi_vel), energy=t(s.energy),
                             poi_done=t(s.poi_done), t=t(s.t).to(torch.int32))
    st.obs, st.ou_state = t(jst.obs), t(jst.ou_state)
    st.total_steps, st.iteration = int(jst.total_steps), int(jst.iteration)
    return st


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(key, n_steps, shape):
    def one(k):
        k_ou, k_rand = jax.random.split(k)
        return (jax.random.normal(k_ou, shape, jnp.float32),
                jax.random.uniform(k_rand, shape, jnp.float32, -1.0, 1.0))

    return jax.vmap(one)(jax.random.split(key, n_steps))


def _collect_draws(key, n_steps, shape=(2, 3, 2)):
    """The OU noise and warm-up actions of JAX's ``collect(key, n_steps)``,
    (n_steps, E, N, act) each."""
    return tuple(torch.tensor(_np(x)) for x in _jax_draws(key, n_steps, shape))


def _indices(key, jst, batch):
    """The buffer rows JAX's ``update_once(jst, key)`` draws."""
    return torch.tensor(_np(jax.random.randint(
        key, (batch,), 0, jnp.maximum(jst.buffer.size, 1))).astype(np.int64))


def _hold_nets(st, jst, what):
    for net in NETS:
        flax = state_dict_to_rlkit_flax(getattr(st, net).state_dict())["params"]
        want = _np_tree(getattr(jst, JNETS[net]))["params"]
        for layer, leaves in want.items():
            for name, val in leaves.items():
                _close(flax[layer][name], val, f"{what}: {net}.{layer}.{name}")


def _hold_adam(st, jst, what):
    """Adam moments: torch's exp_avg / exp_avg_sq against optax's mu / nu,
    and the step count."""
    for net, jopt in (("actor", jst.actor_opt), ("critic", jst.critic_opt)):
        adam = jopt[0]
        opt = getattr(st, f"{net}_opt")
        for name, p in getattr(st, net).named_parameters():
            layer, leaf = name.split(".")
            state = opt.state[p]
            assert int(state["step"]) == int(_np(adam.count)[0]), (what, net)
            _close(state["exp_avg"], adam.mu["params"][layer][leaf], f"{what}: mu {net}.{name}")
            _close(state["exp_avg_sq"], adam.nu["params"][layer][leaf],
                   f"{what}: nu {net}.{name}", atol=1e-12)


def _collected(pair):
    """JAX's state after 12 steps of collection from init (the buffer
    full and wrapped), and the port's copy of it."""
    _, fns, algo = pair
    jst, _ = fns["collect"](fns["init"], jax.random.PRNGKey(1), 12)
    return jst, _port_state(algo, jst)


def test_init_shapes_and_targets_are_copies(pair):
    _, _, algo = pair
    st = algo.init_state(seed=3)
    assert st.actor.fc0.kernel.shape == (3, 38, 8)  # flax's (in, out) per agent
    assert st.critic.fc0.kernel.shape == (3, 3 * 38 + 3 * 2, 8)
    assert st.critic.last_fc.kernel.shape == (3, 8, 1)
    assert st.buffer.obs.shape == (16, 3, 38) and st.obs.shape == (2, 3, 38)
    assert (st.buffer.ptr, st.buffer.size, st.total_steps) == (0, 0, 0)
    # rlkit init: fan-in bound on the hidden kernel, biases 0.1, last layer 3e-3
    assert float(st.actor.fc0.kernel.detach().abs().max()) <= 38 ** -0.5
    assert torch.all(st.actor.fc0.bias == 0.1)
    assert float(st.critic.last_fc.bias.detach().abs().max()) <= 3e-3
    for net, tgt in (("actor", "target_actor"), ("critic", "target_critic")):
        for p, q in zip(getattr(st, net).parameters(), getattr(st, tgt).parameters()):
            assert torch.equal(p, q)
            assert p.data_ptr() != q.data_ptr()  # a copy: soft updates must move it
            assert not q.requires_grad


def test_actors_apply_per_agent(pair):
    _, fns, algo = pair
    jst = fns["init"]
    st = _port_state(algo, jst)
    obs = torch.tensor(np.random.default_rng(0).standard_normal((5, 3, 38)), dtype=torch.float32)
    got = algo._actors(st.actor, obs)
    _close(got, fns["actors"](jst.actor_params, jnp.asarray(obs.numpy())), "actors")
    a = st.actor
    for i in range(3):  # agent i's parameters on agent i's observation
        h = F.gelu(obs[:, i] @ a.fc0.kernel[i] + a.fc0.bias[i], approximate="tanh")
        want = torch.tanh(h @ a.last_fc.kernel[i] + a.last_fc.bias[i])
        torch.testing.assert_close(got[:, i], want, rtol=RTOL, atol=ATOL)
    action, logp = algo.act(st, obs.reshape(15, 38))
    assert logp is None and torch.equal(action, got.reshape(15, 2))


def test_collect_matches_jax(pair):
    """12 steps of 2 envs into a 16-row buffer (it wraps), across the
    warm-up (4 env steps): the buffer, its pointers, the OU state (reset
    where an episode ended), the env and the metrics."""
    _, fns, algo = pair
    key = jax.random.PRNGKey(1)
    jst, (jrew, jcov) = fns["collect"](fns["init"], key, 12)
    st = _port_state(algo, fns["init"])
    noise, uniform = _collect_draws(key, 12)
    rew, cov = algo.collect(st, 12, noise=noise, uniform=uniform)
    assert (st.buffer.ptr, st.buffer.size, st.total_steps) == (24 % 16, 16, 24)
    assert (int(jst.buffer.ptr), int(jst.buffer.size)) == (st.buffer.ptr, st.buffer.size)
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        _close(getattr(st.buffer, k), getattr(jst.buffer, k), f"buffer.{k}")
    _close(st.ou_state, jst.ou_state, "ou_state")
    _close(st.obs, jst.obs, "obs")
    _close(st.env_states.pos, jst.env_states.pos, "env pos")
    _close(rew, jrew, "reward")
    _close(cov, jcov, "coverage")


def test_ou_resets_where_an_episode_ends(pair):
    """An env that leaves the hard bound is done: its OU state returns to
    ou_mu, the buffer stores done 1 and the reset observation as next_obs."""
    jalgo, fns, algo = pair
    st = algo.init_state(seed=0)
    st.env_states.pos[1] = 1.49  # the next step takes env 1 past the hard bound 1.5
    st.env_states.vel[1] = 0.5
    st.ou_state.fill_(0.3)
    noise = torch.zeros((1, 2, 3, 2))
    algo.collect(st, 1, noise=noise, uniform=torch.ones((1, 2, 3, 2)))
    assert torch.all(st.ou_state[1] == 0.0)
    assert torch.allclose(st.ou_state[0], torch.full((3, 2), 0.3 - 0.15 * 0.3))
    assert st.buffer.dones[:2, 0].tolist() == [0.0, 1.0]
    assert torch.all(st.buffer.next_obs[1] == st.obs[1])
    assert float(st.obs[1, :, 2:4].abs().max()) == 0.0  # the reset puts agents at the origin


@pytest.mark.parametrize("done", [0.0, 1.0])
def test_td_target(pair, done):
    """The critic's loss is mean((Q - (reward_scale r + (1 - done) gamma
    Q_target(next)))^2) per agent, averaged over agents."""
    _, _, algo = pair
    st = algo.init_state(seed=1)
    g = torch.Generator().manual_seed(0)
    buf = st.buffer
    for k in ("obs", "next_obs"):
        getattr(buf, k).copy_(torch.randn(getattr(buf, k).shape, generator=g))
    buf.actions.uniform_(-1, 1, generator=g)
    buf.rewards.copy_(torch.randn(buf.rewards.shape, generator=g) * 50)
    buf.dones.fill_(done)
    buf.size = 16
    idx = torch.arange(8)
    cfg = algo.cfg
    with torch.no_grad():
        nobs, obs = buf.next_obs[idx].reshape(8, -1), buf.obs[idx].reshape(8, -1)
        nact = algo._actors(st.target_actor, buf.next_obs[idx]).reshape(8, -1)
        q_next = st.target_critic(torch.cat([nobs, nact], -1).expand(3, 8, -1))
        target = cfg.reward_scale * buf.rewards[idx] + (1 - done) * cfg.gamma * q_next
        q = st.critic(torch.cat([obs, buf.actions[idx].reshape(8, -1)], -1).expand(3, 8, -1))
        want = ((q - target) ** 2).mean(dim=(1, 2)).mean()
    c_loss, _ = algo.update_once(st, idx)
    assert torch.allclose(c_loss, want, rtol=1e-6)


def test_update_once_matches_jax(pair):
    """One update from the same state and rows: both losses, every
    parameter of the four networks, and both Adams' moments."""
    jalgo, fns, algo = pair
    jst, st = _collected(pair)
    key = jax.random.PRNGKey(7)
    jst1, (jc, ja) = fns["update"](jst, key)
    c, a = algo.update_once(st, _indices(key, jst, 8))
    _close(c, jc, "critic loss")
    _close(a, ja, "actor loss")
    _hold_nets(st, jst1, "one update")
    _hold_adam(st, jst1, "one update")


def test_update_once_with_value_clip(pair):
    """clip_grad > 0: every gradient element clipped before Adam
    (optax.clip), against JAX's."""
    jalgo = JMADDPG(JMADDPGConfig(**CFG, clip_grad=1e-3), JEnvConfig(**ENV))
    algo = MADDPG(MADDPGConfig(**CFG, clip_grad=1e-3), EnvConfig(**ENV), device="cpu")
    jst, _ = _collected(pair)
    jst = jst.replace(actor_opt=jax.vmap(jalgo.actor_tx.init)(jst.actor_params),
                      critic_opt=jax.vmap(jalgo.critic_tx.init)(jst.critic_params))
    st = _port_state(algo, jst)
    key = jax.random.PRNGKey(8)
    jst1, (jc, ja) = jax.jit(jalgo.update_once)(jst, key)
    c, a = algo.update_once(st, _indices(key, jst, 8))
    _close(c, jc, "critic loss")
    _close(a, ja, "actor loss")
    _hold_nets(st, jst1, "clipped update")
    adam = jst1.actor_opt[1][0]  # chain(clip, adam): the adam state is second
    _close(st.actor_opt.state[st.actor.fc0.kernel]["exp_avg"], adam.mu["params"]["fc0"]["kernel"],
           "clipped mu")


def test_train_iteration_gated_then_updating(pair):
    """The gate: with a batch of 32 an iteration's 12 rows run no update:
    zero losses, the networks unchanged, the collect's metrics. Then from
    the 12-step state with batch 8 an iteration collects 12 more rows and
    runs 3 updates, against JAX's."""
    _, fns, algo = pair
    key = jax.random.PRNGKey(11)
    k_collect, k_update = jax.random.split(key)
    noise, uniform = _collect_draws(k_collect, 6)

    gated = MADDPG(MADDPGConfig(**dict(CFG, batch_size=32)), EnvConfig(**ENV), device="cpu")
    st = _port_state(gated, fns["init"])
    before = [p.clone() for net in NETS for p in getattr(st, net).parameters()]
    m = gated.train_iteration(st, noise=noise, uniform=uniform)
    assert m["qf_loss"] == 0.0 and m["policy_loss"] == 0.0
    assert all(torch.equal(p, q) for p, q in zip(
        before, [p for net in NETS for p in getattr(st, net).parameters()]))
    assert (st.iteration, st.buffer.size) == (1, 12)
    reward, coverage = gated.collect(_port_state(gated, fns["init"]), 6, noise, uniform)
    assert (m["reward"], m["coverage_rate"]) == (float(reward), float(coverage))

    jst, st = _collected(pair)
    # the updates draw their rows from the buffer the collect filled
    jst_c, _ = fns["collect"](jst, k_collect, 6)
    idx = torch.stack([_indices(k, jst_c, 8) for k in jax.random.split(k_update, 3)])
    m = algo.train_iteration(st, noise=noise, uniform=uniform, indices=idx)
    jst1, jm = fns["train"](jst, key)
    for k in m:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    _hold_nets(st, jst1, "train_iteration")
    _hold_adam(st, jst1, "train_iteration")
    assert st.iteration == int(jst1.iteration)


def test_eval_iteration_matches_jax(pair):
    """Deterministic policy from the deterministic reset: the sum over steps
    of the mean reward and the mean best coverage, as JAX's."""
    jalgo, fns, algo = pair
    jst, st = _collected(pair)
    got = algo.eval_iteration(st, 2)
    want = fns["eval"](jst, jax.random.PRNGKey(3))
    for k in ("reward", "coverage_rate"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_factory_dispatch():
    env = EnvConfig(**ENV)
    assert isinstance(make_algo(load_yaml_merged(overrides={"algo_file": "maddpg"}), env,
                                device="cpu"), MADDPG)
    assert isinstance(make_algo(load_yaml_merged(), env, device="cpu"), MAPPO)
    with pytest.raises(NotImplementedError, match="not found"):
        make_algo({"algo_file": "qmix"}, env, device="cpu")


@pytest.mark.parametrize("name", ["maddpg.yaml", "maddpg_tuned.yaml"])
def test_yaml_loads_as_jax(name):
    """Both YAMLs, the port's copies, map to the JAX package's config."""
    got = to_maddpg_config(load_yaml_merged(
        algo_yaml=os.path.join(ROOT, "dcc_tpu_torch", "configs", "algo_config", name)))
    want = j_to_maddpg_config(j_load_yaml_merged(
        algo_yaml=os.path.join(ROOT, "dcc_tpu", "configs", "algo_config", name)))
    assert got._asdict() == want._asdict()
    if name == "maddpg_tuned.yaml":
        assert (got.hidden_sizes, got.batch_size, got.updates_per_iter,
                got.warmup_steps) == ((128, 128), 1024, 150, 3000)


def test_discrete_modes_refused():
    with pytest.raises(NotImplementedError, match="continuous-control"):
        MADDPG(MADDPGConfig(**CFG), EnvConfig(action_mode="multi_discrete"), device="cpu")
    with pytest.raises(NotImplementedError, match="continuous-control"):
        make_algo(load_yaml_merged(overrides={"algo_file": "maddpg", "discrete_actions": True}),
                  EnvConfig(discrete_actions=True), device="cpu")


SMALL_RUN = dict(algo_file="maddpg", num_agents=3, num_pois=6, n_rollout_threads=2,
                 max_ep_len=6, batch_size=8, buffer_capacity=16, warmup_steps=4,
                 updates_per_iter=3, hidden_sizes_mlp=[8], n_eval_rollout_threads=2,
                 eval_interval=1, save_gifs=False)


def test_learner_trains_and_renders(tmp_path):
    """Two iterations through the Learner on the CPU, with eval, the metric
    sections and a GIF over MADDPG's horizon."""
    learner = Learner(dict(SMALL_RUN, n_iters=2, main_save_path=str(tmp_path),
                           save_gifs=True, render_interval=2, save_interval=2), device="cpu")
    assert isinstance(learner.algo, MADDPG)
    learner.train()
    assert set(learner.last_metrics) == {"reward", "coverage_rate", "qf_loss", "policy_loss"}
    assert all(np.isfinite(v) for v in learner.last_metrics.values())
    assert learner.ts.iteration == 2
    assert (tmp_path / "uav_dcc").exists()
    assert os.path.getsize(os.path.join(learner.output_path, "models_2.gif")) > 0
    states = learner.render(str(tmp_path / "again.gif"))
    assert states["pos"].shape == (6 + 1, 3, 2)  # steps_per_iter + 1 states
    assert set(learner.timer.summary()) >= {"collect", "update", "eval", "render"}


def test_checkpoint_resume_is_exact(tmp_path):
    """Train 1 iteration, save, restore into a fresh state, train 1 more:
    every parameter, target and Adam moment equals a 2-iteration run's bit
    for bit, and so do the buffer, env, OU state and counters."""
    overrides = dict(SMALL_RUN, save_model=False)
    _, env_cfg, _ = load_config(overrides)
    cfg = to_maddpg_config(load_yaml_merged(overrides=overrides))
    algo = MADDPG(cfg, env_cfg, device="cpu")
    ref = algo.init_state(seed=5)
    algo.train_iteration(ref)
    algo.train_iteration(ref)

    st = algo.init_state(seed=5)
    algo.train_iteration(st)
    path = str(tmp_path / "models_1.pt")
    ckpt.save(path, st)
    resumed = ckpt.load(path, algo.init_state(seed=99))
    assert (resumed.iteration, resumed.total_steps, resumed.buffer.ptr) == (1, 12, 12)
    algo.train_iteration(resumed)
    for net in NETS:
        for (k, p), q in zip(getattr(ref, net).state_dict().items(),
                             getattr(resumed, net).state_dict().values()):
            assert torch.equal(p, q), (net, k)
    for opt in ("actor_opt", "critic_opt"):
        for a, b in zip(getattr(ref, opt).state.values(), getattr(resumed, opt).state.values()):
            assert all(torch.equal(a[k], b[k]) for k in a), opt
    for k in ("obs", "actions", "rewards", "next_obs", "dones"):
        assert torch.equal(getattr(ref.buffer, k), getattr(resumed.buffer, k)), k
    assert torch.equal(ref.ou_state, resumed.ou_state)
    assert torch.equal(ref.env_states.pos, resumed.env_states.pos)
    assert (ref.buffer.ptr, ref.buffer.size, ref.total_steps, ref.iteration) == (
        resumed.buffer.ptr, resumed.buffer.size, resumed.total_steps, resumed.iteration)
