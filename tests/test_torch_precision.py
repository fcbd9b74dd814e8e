"""The precision arms against the JAX package: the golden-trace harness, the
compensated env step and MAPPO on the float64 env.

* ``dcc_tpu_torch.compat.compare`` replays all six reference traces in f64
  at ``tests/test_env_parity.py``'s tolerances (obs 1e-10 and reward 1e-8,
  ``connect_4x20`` 1e-6 / 1e-5; dones exact; coverage and the reset obs
  1e-12).
* The compensated f32 env step of the connect variant (``comm_force_scale``
  5, ``comm_r_scale`` 0.95), taken by both packages from JAX's states along
  a connect run with random actions: the f32 tolerances of
  ``tests/test_torch_env.py`` (obs atol 1e-5, reward rtol 1e-5 / atol
  1e-4), with the pull force engaged on many of the steps.
* MAPPO with ``env_dtype="float64"`` (2 envs, an 8-step episode, the same
  parameters through ``compat.flax_params``): a deterministic rollout
  against JAX's f64 rollout, every stored field at the f32 rollout's atol
  1e-4 (``tests/test_torch_slice.py``) and obs, rewards and coverage stored
  in f32; then one f32 update from JAX's sampled f64 trajectory at the f32
  update's bounds (parameters atol 3e-5, metrics rtol 1e-4 / atol 1e-6).
* The ``ValueError`` of an unknown ``env_dtype``, and the refusal of f64 on
  ``spread``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.envs import reset_batch as j_reset_batch
from dcc_tpu.envs import step_batch as j_step_batch
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig, Trajectory
from dcc_tpu_torch.compat import DEFAULT_GOLDEN_DIR, compare, load_golden, replay
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig, connectivity, step_batch
from test_torch_env import _from_jax
from test_torch_slice import SMALL, _to_torch

CONNECT = dict(comm_force_scale=5.0, comm_r_scale=0.95)


@pytest.fixture(scope="module")
def pair():
    """JAX's MAPPO and the port's on the f64 connect env, from the same
    parameters; both run their plain trunk, loss and GAE. The rollout test
    leaves the states as they were; the update test moves the port's."""
    kw = dict(fused_loss="off", fused_trunk="off", gae_backend="xla", env_dtype="float64",
              **SMALL)
    jalgo = JMAPPO(JMAPPOConfig(**kw), JEnvConfig(**CONNECT))
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(**kw), EnvConfig(**CONNECT), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


@pytest.mark.parametrize(
    "name,tol_obs,tol_rew",
    [
        ("default_4x20", 1e-10, 1e-8),
        ("connect_4x20", 1e-6, 1e-5),
        ("connect_smallact_4x20", 1e-10, 1e-8),
        ("default_5x10", 1e-10, 1e-8),
        ("connect_5x10", 1e-10, 1e-8),
        ("default_10x20", 1e-10, 1e-8),
    ],
)
def test_golden_compare(name, tol_obs, tol_rew):
    trace = load_golden(name)
    err = compare(trace, device="cpu")
    assert set(err) == {"obs0", "obs", "reward", "done", "coverage"}
    assert err["obs0"] <= 1e-12 and err["coverage"] <= 1e-12 and err["done"] == 0.0, err
    assert err["obs"] <= tol_obs and err["reward"] <= tol_rew, err
    obs0, out = replay(trace, device="cpu")
    assert obs0.dtype == out.obs.dtype == torch.float64
    assert out.obs.shape == trace.obs.shape and out.reward.shape == trace.shared_reward.shape


def test_golden_dir_is_the_test_data():
    assert DEFAULT_GOLDEN_DIR.endswith(("tests/golden", "tests\\golden"))
    trace = load_golden("default_4x20")
    assert trace.team_done.shape == trace.shared_reward.shape == trace.coverage.shape


def test_compensated_step_matches_jax_along_a_connect_run():
    kw = dict(**CONNECT, compensated_forces=True)
    jcfg, cfg = JEnvConfig(**kw), EnvConfig(**kw)
    E, steps = 8, 60
    rng = np.random.default_rng(6)
    actions = rng.uniform(-1, 1, (steps, E, cfg.n_agents, 2)).astype(np.float32)
    # agent 0 flies off along its env's heading: it leaves the scaled radius
    # and the pull force holds it near the onset, where the df64 chain matters
    theta = rng.uniform(0, 2 * np.pi, E)
    actions[:, :, 0] = 0.5 * actions[:, :, 0] + np.stack([np.cos(theta), np.sin(theta)], -1)
    js = j_reset_batch(jcfg, jax.random.PRNGKey(0), E)
    n_forced = 0
    for a in actions:
        ts = _from_jax(js)
        n_forced += int((~connectivity(cfg, ts.pos)[4]).sum())
        js, jo = j_step_batch(jcfg, js, jnp.asarray(a))
        ts, to = step_batch(cfg, ts, torch.from_numpy(a))
        assert ts.pos.dtype == torch.float32
        np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=1e-5)
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=1e-5)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
    assert n_forced >= 50  # env steps that ran the pull force


def test_f64_rollout_matches_jax(pair):
    jalgo, jts, algo, ts = pair
    assert algo.env_dtype == torch.float64
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(1), 2, deterministic=True)
    traj = algo.rollout(ts, 2, deterministic=True)
    for f in ("obs", "rewards", "coverage"):
        assert getattr(traj, f).dtype == torch.float32, f
    for f in Trajectory._fields[:8]:
        np.testing.assert_allclose(getattr(traj, f).float().numpy(),
                                   np.asarray(getattr(jtraj, f), np.float32),
                                   atol=1e-4, err_msg=f)


def test_f32_update_from_f64_trajectory_matches_jax(pair):
    jalgo, jts, algo, ts = pair
    # sampled actions: with deterministic ones the first epoch's actor
    # gradient is zero and Adam would turn rounding noise into full steps
    jtraj = jalgo.rollout(jts, jax.random.PRNGKey(3), 2)
    jadv, jret = jalgo.compute_returns(jts, jtraj)
    jts2, jm = jalgo.update(jts, jax.random.PRNGKey(4), jtraj, jadv, jret)
    m = algo.update(ts, _to_torch(jtraj), torch.from_numpy(np.array(jadv)),
                    torch.from_numpy(np.array(jret)))
    for net, jparams in ((ts.actor, jts2.actor_params), (ts.critic, jts2.critic_params)):
        want = flax_to_state_dict(jax.device_get(jparams))
        got = net.state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=3e-5, err_msg=k)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["float64", "f64", "fp64", "float32", "fp32", "f32"])
def test_env_dtype_aliases(name):
    algo = MAPPO(MAPPOConfig(env_dtype=name), EnvConfig(), device="cpu")
    assert algo.env_dtype == (torch.float64 if "64" in name else torch.float32)


def test_env_dtype_refusals():
    with pytest.raises(ValueError, match="unknown env_dtype"):
        MAPPO(MAPPOConfig(env_dtype="float16"), EnvConfig(), device="cpu")
    from dcc_tpu_torch.envs.spread import SpreadConfig

    with pytest.raises(NotImplementedError, match="plumbed for the coverage"):
        MAPPO(MAPPOConfig(env_dtype="float64"), SpreadConfig(), device="cpu", scenario="spread")
