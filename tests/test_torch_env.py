"""The port's batched coverage env against the JAX env and the reference's
golden traces.

Golden traces: float64, at the tolerances of tests/test_env_parity.py.
Batched parity: float32 against ``dcc_tpu.envs.step_batch`` on the same
random actions, across real dones and time-limit auto-resets; f32 tolerance
covers summation-order differences of the reward sums (rtol 1e-5).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.envs import reset_batch as j_reset_batch
from dcc_tpu.envs import step_batch as j_step_batch
from dcc_tpu.envs.vector import share_obs_from_obs as j_share_obs
from dcc_tpu_torch.envs import (
    EnvConfig,
    observation,
    reset,
    reset_batch,
    share_obs_from_obs,
    step,
    step_batch,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


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
def test_golden_trace_float64(name, tol_obs, tol_rew):
    g = np.load(os.path.join(GOLDEN, name + ".npz"))
    cfg = EnvConfig(
        n_agents=int(g["num_agents"]),
        n_pois=int(g["num_pois"]),
        comm_force_scale=float(g["comm_force_scale"]),
        comm_r_scale=float(g["comm_r_scale"]),
    )
    state = reset(cfg, 1, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(observation(cfg, state)[0].numpy(), g["obs0"], atol=1e-12)
    obs, rew, done, cov = [], [], [], []
    for a in g["actions"]:
        state, out = step(cfg, state, torch.tensor(a, dtype=torch.float64)[None])
        obs.append(out.obs[0].numpy())
        rew.append(float(out.reward[0]))
        done.append(bool(out.done[0]))
        cov.append(float(out.coverage_rate[0]))
    np.testing.assert_allclose(np.stack(obs), g["obs"], atol=tol_obs)
    np.testing.assert_allclose(np.array(rew), g["rewards"][:, 0], atol=tol_rew)
    np.testing.assert_array_equal(np.array(done), g["dones"].all(axis=1))
    np.testing.assert_allclose(np.array(cov), g["coverage_rate"], atol=1e-12)


@pytest.mark.parametrize("comm_force_scale", [0.0, 5.0])
def test_step_batch_matches_jax_across_auto_reset(comm_force_scale):
    kw = dict(max_ep_len=36, time_limit=True, comm_force_scale=comm_force_scale)
    jcfg, cfg = JEnvConfig(**kw), EnvConfig(**kw)
    E, steps = 6, 80
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (steps, E, jcfg.n_agents, 2)).astype(np.float32)
    # env 0 flies out along +x (~32 steps): a real done before the time limit
    actions[:, 0] = [1.0, 0.0]
    js = j_reset_batch(jcfg, jax.random.PRNGKey(0), E)
    ts = reset_batch(cfg, E, device="cpu")
    n_done = n_trunc = 0
    for a in actions:
        js, jo = j_step_batch(jcfg, js, jnp.asarray(a))
        ts, to = step_batch(cfg, ts, torch.from_numpy(a))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=1e-5)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.truncated.numpy(), np.asarray(jo.truncated))
        np.testing.assert_allclose(to.coverage_rate.numpy(), np.asarray(jo.coverage_rate),
                                   atol=1e-7)
        np.testing.assert_array_equal(ts.t.numpy(), np.asarray(js.t))
        n_done += int(to.done.sum())
        n_trunc += int(to.truncated.sum())
    assert n_done > 0 and n_trunc > 0  # both reset kinds were exercised


def test_share_obs_matches_jax():
    obs = np.random.default_rng(1).normal(size=(3, 5, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        share_obs_from_obs(torch.from_numpy(obs)).numpy(),
        np.asarray(j_share_obs(jnp.asarray(obs))),
    )


@pytest.mark.parametrize(
    "kw",
    [dict(discrete_actions=True), dict(randomize_pois=True), dict(poi_speed=0.1),
     dict(compensated_forces=True)],
)
def test_unported_env_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reset_batch(EnvConfig(**kw), 2, device="cpu")
