"""The update's variants against ``dcc_tpu.algos.MAPPO.update``, from
identical converted parameters and the same trajectory, under the bounds of
``tests/test_torch_slice.py`` (f32: parameters atol 3e-5, metrics rtol
1e-4):

* PopArt (``use_popart``, ValueNorm off) on the autograd and the fused
  path: the head rescale in place before each step, over two epochs, and
  the PopArt statistics;
* ``update_chunks`` 2 and 4 (gradient accumulation over row chunks);
* ``use_remat`` (``torch.utils.checkpoint``, where JAX has
  ``jax.checkpoint``), which is also bit-equal to the port without it;
* the unfolded fused loss (``fused_fold=False``) with one minibatch.

``train_many`` runs iterations back to back: three of them equal three
``train_iteration`` calls from the same generator state, and its fields
have the shapes of JAX's stacked metrics.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Metrics, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig

SMALL = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=32)


def _jalgo(**kw):
    return JMAPPO(JMAPPOConfig(gae_backend="xla", fused_block_rows=32, fused_trunk="off",
                               **SMALL, **kw), JEnvConfig())


@functools.lru_cache(maxsize=None)
def _trajectory():
    """JAX's sampled rollout of the seed-0 networks (the same networks for
    every variant below: the variants change only the update)."""
    jalgo = _jalgo()
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    return jalgo.rollout(jts, jax.random.PRNGKey(3), 4)


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def _run(jax_kw, port_kw):
    """One update of each side from the seed-0 parameters on the shared
    trajectory; returns (port algo, port state, port metrics, new JAX
    state, JAX metrics)."""
    jalgo = _jalgo(**jax_kw)
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(**SMALL, **port_kw), EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    ts = algo.init_state(actor=actor, critic=critic)
    jtraj = _trajectory()
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    jts2, jm = jalgo.update(jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    adv, ret = algo.compute_returns(ts, _to_torch(jtraj))
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-5)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
    return algo, ts, m, jts2, jm


def _assert_matches(ts, m, jts2, jm):
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=3e-5, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-6)
    assert ts.update_count == int(jts2.update_count)
    assert ts.iteration == int(jts2.iteration) == 1


@pytest.mark.parametrize(
    "jax_loss,port_loss", [("off", "off"), ("interpret", "on")], ids=["autograd", "fused"])
def test_popart_update_matches_jax(jax_loss, port_loss):
    kw = dict(use_popart=True, use_valuenorm=False)
    algo, ts, m, jts2, jm = _run(dict(kw, fused_loss=jax_loss), dict(kw, fused_loss=port_loss))
    assert algo.fused_loss == (port_loss == "on") and ts.vnorm is None
    _assert_matches(ts, m, jts2, jm)
    for f in ("mean", "mean_sq", "debias", "stddev"):
        np.testing.assert_allclose(getattr(ts.popart, f).numpy(),
                                   np.asarray(getattr(jts2.popart, f)), rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("chunks", [2, 4])
def test_update_chunks_match_jax(chunks):
    algo, ts, m, jts2, jm = _run(dict(update_chunks=chunks, fused_loss="off"),
                                 dict(update_chunks=chunks, fused_loss="off"))
    assert ts.update_count == SMALL["ppo_epoch"]
    _assert_matches(ts, m, jts2, jm)


def test_remat_matches_jax_and_the_update_without_it():
    algo, ts, m, jts2, jm = _run(dict(use_remat=True, fused_loss="off"),
                                 dict(use_remat=True, fused_loss="off"))
    _assert_matches(ts, m, jts2, jm)
    _, ts0, m0, _, _ = _run(dict(fused_loss="off"), dict(fused_loss="off"))
    assert torch.equal(m, m0)
    for net, net0 in ((ts.actor, ts0.actor), (ts.critic, ts0.critic)):
        for (k, a), b in zip(net.state_dict().items(), net0.state_dict().values()):
            assert torch.equal(a, b), k


def test_unfolded_fused_update_matches_jax():
    algo, ts, m, jts2, jm = _run(dict(fused_loss="interpret", fused_fold=False),
                                 dict(fused_loss="on", fused_fold=False))
    assert algo.fused_loss
    _assert_matches(ts, m, jts2, jm)


def test_update_options_raise_as_jax():
    """PopArt and ValueNorm are mutually exclusive; update_chunks takes the
    one-minibatch feed-forward path; chunks must divide the rows."""
    env = EnvConfig()
    with pytest.raises(ValueError, match="mutually exclusive"):
        MAPPO(MAPPOConfig(use_popart=True), env, device="cpu")
    for kw in (dict(update_chunks=2, num_mini_batch=2),
               dict(update_chunks=2, use_recurrent_policy=True)):
        with pytest.raises(NotImplementedError, match="update_chunks"):
            MAPPO(MAPPOConfig(**kw), env, device="cpu")
    algo = MAPPO(MAPPOConfig(**dict(SMALL, update_chunks=3)), env, device="cpu")
    ts = algo.init_state(seed=0)
    traj = algo.rollout(ts, 4)
    adv, ret = algo.compute_returns(ts, traj)
    with pytest.raises(ValueError, match="must divide"):
        algo.update(ts, traj, adv, ret)


def test_train_many_equals_train_iterations():
    cfg = MAPPOConfig(**dict(SMALL, num_mini_batch=2))
    algo = MAPPO(cfg, EnvConfig(), device="cpu")
    ts_many, ts_one = algo.init_state(seed=0), algo.init_state(seed=0)
    many = algo.train_many(ts_many, 3)
    one = [algo.train_iteration(ts_one) for _ in range(3)]
    assert isinstance(many, Metrics)
    for f in Metrics._fields:
        got = getattr(many, f)
        assert isinstance(got, torch.Tensor) and got.shape == (3,)
        assert got.tolist() == [getattr(o, f) for o in one], f
    assert ts_many.iteration == ts_one.iteration == 3
    assert ts_many.update_count == ts_one.update_count
    # JAX's train_many stacks each field over the iterations
    jalgo = _jalgo()
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    _, jm = jax.eval_shape(lambda: jalgo.train_many(jts, jax.random.PRNGKey(1), 3))
    assert all(getattr(jm, f).shape == getattr(many, f).shape for f in Metrics._fields)


def test_update_options_reach_the_config_as_in_jax():
    """The CLI's overrides of the update options reach MAPPOConfig as the JAX
    package's loader sets them."""
    from dcc_tpu.configs import loader as jloader
    from dcc_tpu_torch.configs import loader
    from dcc_tpu_torch.train import parse_overrides

    _, overrides = parse_overrides(
        ["--num-mini-batch", "4", "--fused-fold", "false", "--use-popart", "true",
         "--use-valuenorm", "false", "--use-remat", "true", "--update-chunks", "2"])
    _, _, cfg = loader.load(overrides)
    _, _, jcfg = jloader.load(overrides)
    for f in ("num_mini_batch", "fused_fold", "use_popart", "use_valuenorm", "use_remat",
              "update_chunks"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.num_mini_batch, cfg.fused_fold, cfg.use_popart, cfg.use_remat,
            cfg.update_chunks) == (4, False, True, True, 2)
