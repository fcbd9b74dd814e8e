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
1.0e-3 and 1.1e-2 away, outside both bounds."""

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

SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5,
             hidden_size=32)


def _pair(fused_loss="off", compute_dtype="float32"):
    jalgo = JMAPPO(
        JMAPPOConfig(fused_loss="interpret", fused_trunk="interpret", gae_backend="xla",
                     fused_block_rows=32, compute_dtype=compute_dtype, **SMALL),
        JEnvConfig(),
    )
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(fused_loss=fused_loss, compute_dtype=compute_dtype, **SMALL),
                 EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def test_deterministic_rollout_matches_jax():
    jalgo, jts, algo, ts = _pair()
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(1), 4, deterministic=True)
    traj = algo.rollout(ts, 4, deterministic=True)
    for f in Trajectory._fields:
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
    [("off", "float32"), ("on", "float32"), ("on", "bfloat16")],
    ids=["off", "on", "on-bf16"],
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
    with pytest.raises(NotImplementedError, match="K2b"):
        MAPPO(MAPPOConfig(fused_trunk="on", fused_loss="off"), env, device="cpu")


@pytest.mark.parametrize(
    "kw",
    [dict(share_policy=False), dict(use_recurrent_policy=True), dict(use_popart=True),
     dict(num_mini_batch=2), dict(use_remat=True), dict(env_dtype="float64"),
     dict(update_chunks=2), dict(fused_loss="on", fused_fold=False)],
)
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MAPPO(MAPPOConfig(**kw), EnvConfig(), device="cpu")


def test_train_iteration_runs_both_update_paths():
    for fused in ("off", "on"):
        algo = MAPPO(MAPPOConfig(fused_loss=fused, **SMALL), EnvConfig(), device="cpu")
        ts = algo.init_state(seed=0)
        m = algo.train_iteration(ts)
        assert all(np.isfinite(v) for v in m)
        assert ts.iteration == 1 and ts.update_count == SMALL["ppo_epoch"]
