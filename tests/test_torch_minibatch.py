"""``MAPPO.update`` with ``num_mini_batch`` 2 and 3 against
``dcc_tpu.algos.MAPPO.update``, from identical converted parameters and
trajectory, with the same minibatch permutations: each test draws JAX's
(``permutation(key_e, n)`` of each epoch's key from ``split(key,
ppo_epoch)``; n = T*E*A rows feed-forward, C chunks recurrent) and hands
them to the port's ``update(..., perms=)``.

Feed-forward: by autograd, and through the fused loss, folded (K3 / K4) and
unfolded (K3u / K4u), whose plain versions run on the CPU against JAX's
interpreted kernels on the same gathered rows. Recurrent: chunk minibatches
with ``data_chunk_length`` 4. Bounds of ``tests/test_torch_slice.py`` (f32):
parameters atol 3e-5, metrics rtol 1e-4.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig

FF = dict(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=32)
RECURRENT = dict(n_rollout_threads=2, episode_length=8, ppo_epoch=2, n_iters=5, hidden_size=16,
                 use_recurrent_policy=True, data_chunk_length=4)


def _pair(jax_kw, port_kw, small):
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", fused_block_rows=32, **small, **jax_kw),
                   JEnvConfig())
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(**small, **port_kw), EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


def _to_torch(jtraj):
    return Trajectory(*(None if getattr(jtraj, f) is None
                        else torch.from_numpy(np.array(getattr(jtraj, f), np.float32))
                        for f in Trajectory._fields))


def jax_perms(key, n, epochs):
    """The permutations JAX's update draws from ``key``: one of ``n`` per
    epoch."""
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, epochs)])


@functools.lru_cache(maxsize=None)
def _trajectory(recurrent: bool):
    """JAX's sampled rollout of the seed-0 networks, shared by the tests of
    one policy (the minibatch options change only the update)."""
    small = RECURRENT if recurrent else FF
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", fused_trunk="off", **small), JEnvConfig())
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    return jalgo.rollout(jts, jax.random.PRNGKey(3), small["n_rollout_threads"])


def run_both(jalgo, jts, algo, ts, n_perm):
    """One update of each side on JAX's sampled rollout; the port gets JAX's
    permutations of ``n_perm(T, E, A)`` items. Returns (new JAX state, JAX
    metrics, port metrics)."""
    jtraj = _trajectory(algo.recurrent)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    key = jax.random.PRNGKey(4)
    jts2, jm = jalgo.update(jts, key, jtraj, jadv, jret)
    T, E, A, _ = jtraj.actions.shape
    perms = jax_perms(key, n_perm(T, E, A), algo.cfg.ppo_epoch)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)), perms=perms)
    return jts2, jm, m


def assert_matches(ts, jts2, m, jm, param_atol=3e-5, rtol=1e-4, atol=1e-6):
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=param_atol,
                                       err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=rtol, atol=atol)
    assert ts.update_count == int(jts2.update_count)
    assert ts.iteration == int(jts2.iteration) == 1


@pytest.mark.parametrize("nmb", [2, 3])
@pytest.mark.parametrize(
    "path", [
        (dict(fused_loss="off"), dict(fused_loss="off")),
        (dict(fused_loss="interpret"), dict(fused_loss="on")),
        (dict(fused_loss="interpret", fused_fold=False), dict(fused_loss="on", fused_fold=False)),
    ],
    ids=["autograd", "fused-folded", "fused-unfolded"],
)
def test_feed_forward_minibatches_match_jax(path, nmb):
    jax_kw, port_kw = path
    jalgo, jts, algo, ts = _pair(dict(jax_kw, num_mini_batch=nmb, fused_trunk="off"),
                                 dict(port_kw, num_mini_batch=nmb), FF)
    assert algo.fused_loss == (port_kw["fused_loss"] == "on")
    jts2, jm, m = run_both(jalgo, jts, algo, ts, lambda T, E, A: T * E * A)
    assert ts.update_count == FF["ppo_epoch"] * nmb
    assert_matches(ts, jts2, m, jm)


@pytest.mark.parametrize("nmb", [2, 3])
def test_recurrent_minibatches_match_jax(nmb):
    jalgo, jts, algo, ts = _pair(dict(num_mini_batch=nmb, fused_trunk="off"),
                                 dict(num_mini_batch=nmb, fused_trunk="off"), RECURRENT)
    # C = E * A * (T / L) chunks: 2 * 4 * 2 = 16
    jts2, jm, m = run_both(jalgo, jts, algo, ts, lambda T, E, A: E * A * (T // 4))
    assert ts.update_count == RECURRENT["ppo_epoch"] * nmb
    assert_matches(ts, jts2, m, jm)


def test_minibatch_errors():
    """More minibatches than recurrent chunks raise ValueError, as in JAX;
    permutations of the wrong count are refused."""
    algo = MAPPO(MAPPOConfig(**dict(RECURRENT, num_mini_batch=17)), EnvConfig(), device="cpu")
    ts = algo.init_state(seed=0)
    traj = algo.rollout(ts, 2)
    adv, ret = algo.compute_returns(ts, traj)
    with pytest.raises(ValueError, match="exceeds the number of data chunks"):
        algo.update(ts, traj, adv, ret)
    algo = MAPPO(MAPPOConfig(**dict(FF, num_mini_batch=2)), EnvConfig(), device="cpu")
    ts = algo.init_state(seed=0)
    traj = algo.rollout(ts, 4)
    adv, ret = algo.compute_returns(ts, traj)
    with pytest.raises(ValueError, match="permutations"):
        algo.update(ts, traj, adv, ret, perms=np.zeros((1, 128), np.int64))


def test_drawn_permutations_follow_the_generator():
    """Without ``perms`` the permutations come from the generator: the same
    generator state gives the same update."""
    results = []
    for _ in range(2):
        algo = MAPPO(MAPPOConfig(**dict(FF, num_mini_batch=3)), EnvConfig(), device="cpu")
        ts = algo.init_state(seed=0)
        traj = algo.rollout(ts, 4)
        adv, ret = algo.compute_returns(ts, traj)
        results.append((algo.update(ts, traj, adv, ret),
                        [p.detach().clone() for p in ts.critic.parameters()]))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
