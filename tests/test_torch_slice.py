"""The slice end to end against ``dcc_tpu.algos.MAPPO``, from identical
converted parameters: a deterministic rollout gives the same trajectory,
``compute_returns`` the same advantages and returns, and one ``update`` on
the same trajectory the same parameters (atol 3e-5, as
tests/test_fused_ppo.py:254) and metrics, with the port's update by
autograd ("off") and by the fused kernels' plain versions ("on"). The JAX
reference runs its kernels interpreted (``fused_*="interpret"``,
``gae_backend="xla"``).

The update also runs in bf16, the mode in which the main path launches the
fused kernels, against JAX's bf16 fused update: parameters within 1e-4 and
metrics within rtol 2e-3 / atol 1e-5. Single bf16 rounding flips in the
gradients move Adam's normalized steps (measured 2.8e-5 on the parameters,
4.7e-4 relative on the value loss); the port's update computed in f32 lands
1.0e-3 and 1.1e-2 away, outside both bounds. The bf16 update with the fused
loss off (autograd through the fused trunk, K2 / K2b plain versions) is held
to the same bounds against JAX's with its interpreted trunk kernel.

The options the port accepts beyond the default config (no GAE, proper time
limits, the value-loss variants, no gradient clip, no value normalizer,
weight decay, no feature norm, tanh, no LR decay, the env's collision
penalty and connectivity force, a third layer) each run the update on both
paths against JAX's under the f32 bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.ops.fused_mlp import relu_kink_rows
from test_torch_cuda import pretend_cuda

SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5,
             hidden_size=32)


def _pair(fused_loss="off", compute_dtype="float32", env_kw=None, **kw):
    bf16 = compute_dtype == "bfloat16"
    env_kw = env_kw or {}
    # JAX's bf16 autograd update differentiates through its interpreted
    # trunk kernel (K2b); its other updates use the interpreted fused loss
    jalgo = JMAPPO(
        JMAPPOConfig(fused_loss="off" if fused_loss == "off" and bf16 else "interpret",
                     fused_trunk="interpret", gae_backend="xla", fused_block_rows=32,
                     compute_dtype=compute_dtype, **SMALL, **kw),
        JEnvConfig(**env_kw),
    )
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(fused_loss=fused_loss, fused_trunk="on" if bf16 else "auto",
                             compute_dtype=compute_dtype, **SMALL, **kw),
                 EnvConfig(**env_kw), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    """The JAX trajectory as the port's; the hidden-state fields of a
    feed-forward rollout stay None."""
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def test_deterministic_rollout_matches_jax():
    jalgo, jts, algo, ts = _pair()
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(1), 4, deterministic=True)
    traj = algo.rollout(ts, 4, deterministic=True)
    assert traj.actor_h is None and traj.critic_h is None
    for f in Trajectory._fields[:8]:
        np.testing.assert_allclose(getattr(traj, f).float().numpy(),
                                   np.asarray(getattr(jtraj, f), np.float32),
                                   atol=1e-4, err_msg=f)


def test_compute_returns_matches_jax():
    jalgo, jts, algo, ts = _pair()
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(2), 4)
    # a non-trivial value normalizer on both sides
    ret0 = np.random.default_rng(0).normal(size=(8, 4, 1)).astype(np.float32) * 5 + 2
    from dcc_tpu.models import valuenorm as JVN
    from dcc_tpu_torch.models import valuenorm as VN

    jts = jts.replace(vnorm=JVN.update(jts.vnorm, jnp.asarray(ret0)))
    ts.vnorm = VN.update(ts.vnorm, torch.from_numpy(ret0))
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    adv, ret = algo.compute_returns(ts, _to_torch(jtraj))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "fused_loss,compute_dtype",
    [("off", "float32"), ("on", "float32"), ("on", "bfloat16"), ("off", "bfloat16")],
    ids=["off", "on", "on-bf16", "off-bf16"],
)
def test_update_matches_jax(fused_loss, compute_dtype):
    jalgo, jts, algo, ts = _pair(fused_loss, compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    assert algo.fused_loss == (fused_loss == "on")
    # sampled actions: with deterministic ones the first-epoch actor gradient
    # is exactly zero and Adam would turn rounding noise into full steps
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(3), 4)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    jts2, jm = jalgo.update(jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-4 if bf16 else 3e-5, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=2e-3 if bf16 else 1e-4,
                               atol=1e-5 if bf16 else 1e-6)
    assert ts.update_count == int(jts2.update_count) == 2
    assert ts.iteration == int(jts2.iteration) == 1


def test_dispatch_rules_on_cpu():
    env = EnvConfig()
    algo = MAPPO(MAPPOConfig(), env, device="cpu")
    assert not (algo.fused_trunk or algo.fused_loss or algo.gae_kernel)
    algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16"), env, device="cpu")
    assert not (algo.fused_trunk or algo.fused_loss)  # auto picks kernels on CUDA only
    algo = MAPPO(MAPPOConfig(fused_loss="on", fused_trunk="on", gae_backend="pallas"),
                 env, device="cpu")
    assert algo.fused_trunk and algo.fused_loss and algo.gae_kernel
    # the fused trunk under autograd: its backward is K2b
    algo = MAPPO(MAPPOConfig(fused_trunk="on", fused_loss="off"), env, device="cpu")
    assert algo.fused_trunk and not algo.fused_loss


@pytest.mark.parametrize(
    "kw,trunk,loss",
    [(dict(), False, False), (dict(compute_dtype="bfloat16"), True, True),
     (dict(compute_dtype="bfloat16", fused_loss="off"), True, False),
     (dict(compute_dtype="bfloat16", use_recurrent_policy=True), True, False),
     (dict(compute_dtype="bfloat16", use_naive_recurrent=True), True, False),
     (dict(use_recurrent_policy=True), False, False)],
    ids=["f32", "bf16", "bf16-loss-off", "recurrent-bf16", "naive-bf16", "recurrent-f32"],
)
def test_dispatch_rules_on_cuda(monkeypatch, kw, trunk, loss):
    """What "auto" picks on a CUDA device (construction touches no device
    memory, so a CUDA device is pretended, with the kernels' tile sizes from
    their Python layouts): the trunk kernels K2 / K2b in bf16, the fused
    loss K3 / K4 in bf16 on the feed-forward policy only, never with
    recurrence; GAE K1 always."""
    pretend_cuda(monkeypatch)
    algo = MAPPO(MAPPOConfig(**kw), EnvConfig(), device="cuda")
    assert (algo.fused_trunk, algo.fused_loss, algo.gae_kernel) == (trunk, loss, True)


@pytest.mark.parametrize("kw", [dict(env_dtype="float64")])
def test_unported_options_raise(kw):
    """env_dtype="float64", refused until the port ran it, builds
    (tests/test_torch_precision.py holds its rollout against JAX); a dtype
    outside both alias sets raises as JAX's does."""
    assert MAPPO(MAPPOConfig(**kw), EnvConfig(), device="cpu").env_dtype == torch.float64
    with pytest.raises(ValueError, match="unknown env_dtype"):
        MAPPO(MAPPOConfig(env_dtype="float16"), EnvConfig(), device="cpu")


# Options the port accepts beyond the default config, each alone: (id,
# MAPPOConfig fields, EnvConfig fields, rollout key). layer_N=2 takes rollout
# key 5: at key 3 one critic fc1 pre-activation lies 3e-7 from the relu kink
# and the two sides' summation orders put it on opposite sides (8.2e-4 on the
# parameters); the test checks that its data is clear of a kink.
OPTIONS = [
    ("no-gae", dict(use_gae=False), {}, 3),
    ("proper-time-limits", dict(use_proper_time_limits=True), dict(time_limit=True), 3),
    ("unclipped-value-loss", dict(use_clipped_value_loss=False), {}, 3),
    ("mse", dict(use_huber_loss=False), {}, 3),
    ("no-max-grad-norm", dict(use_max_grad_norm=False), {}, 3),
    ("no-valuenorm", dict(use_valuenorm=False), {}, 3),
    ("weight-decay", dict(weight_decay=0.01), {}, 3),
    ("no-feature-norm", dict(use_feature_normalization=False), {}, 3),
    ("tanh", dict(use_relu=False), {}, 3),
    ("no-lr-decay", dict(use_linear_lr_decay=False), {}, 3),
    ("collision-penalty", {}, dict(collision_penalty=10.0), 3),
    ("comm-force", {}, dict(comm_force_scale=5.0), 3),
    ("layer-n-2", dict(layer_n=2), {}, 5),
]


@pytest.mark.parametrize("fused_loss", ["off", "on"])
@pytest.mark.parametrize("kw,env_kw,key", [o[1:] for o in OPTIONS], ids=[o[0] for o in OPTIONS])
def test_options_match_jax(kw, env_kw, key, fused_loss):
    """Each option alone, on the autograd and the fused path: returns and one
    update against JAX's (the bounds of test_update_matches_jax in f32); an
    env option also gives JAX's deterministic rollout."""
    jalgo, jts, algo, ts = _pair(fused_loss, env_kw=env_kw, **kw)
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(key), 4)
    traj = _to_torch(jtraj)
    if env_kw and fused_loss == "off":
        jdet = jalgo.rollout(jts, jax.random.PRNGKey(1), 4, deterministic=True)
        det = algo.rollout(ts, 4, deterministic=True)
        for f in Trajectory._fields[:8]:
            np.testing.assert_allclose(getattr(det, f).float().numpy(),
                                       np.asarray(getattr(jdet, f), np.float32),
                                       atol=1e-4, err_msg=f)
    if algo.cfg.use_relu:
        T, E, A, D = traj.obs[:-1].shape
        for net, x in ((ts.actor, traj.obs[:-1].reshape(-1, D)),
                       (ts.critic, traj.obs[:-1].reshape(T * E, A * D))):
            base = net.base
            assert not relu_kink_rows(x, [p.detach() for p in base.flat_params()],
                                      base.n_layers, base.use_fn).any()
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    adv, ret = algo.compute_returns(ts, traj)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-4)
    jts2, jm = jalgo.update(jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    m = algo.update(ts, traj, torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=3e-5, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-6)


def test_train_iteration_runs_both_update_paths():
    for fused in ("off", "on"):
        algo = MAPPO(MAPPOConfig(fused_loss=fused, **SMALL), EnvConfig(), device="cpu")
        ts = algo.init_state(seed=0)
        m = algo.train_iteration(ts)
        assert all(np.isfinite(v) for v in m)
        assert ts.iteration == 1 and ts.update_count == SMALL["ppo_epoch"]
