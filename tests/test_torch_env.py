"""The port's batched coverage env against the JAX env and the reference's
golden traces.

Golden traces: float64, at the tolerances of tests/test_env_parity.py.
Batched parity: float32 against ``dcc_tpu.envs.step_batch`` on the same
random actions, across real dones and time-limit auto-resets; f32 tolerance
covers summation-order differences of the reward sums (rtol 1e-5). So are
every action mode, the moving and randomized PoIs and the collision
penalty, stepped from JAX's states.
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
    EnvState,
    decode_action,
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
    """Every env option is ported now. Discrete actions, randomized and
    moving PoIs and the compensated pull force, each refused until the port
    ran it, reset and step (held against JAX in tests/test_torch_env.py's
    mode and PoI tests below and in tests/test_torch_df64.py)."""
    cfg = EnvConfig(**kw)
    gen = torch.Generator().manual_seed(0)
    states = reset_batch(cfg, 2, device="cpu", generator=gen)
    actions = torch.ones((2, cfg.n_agents, cfg.action_width))
    states, out = step_batch(cfg, states, actions, gen)
    assert out.obs.shape == (2, cfg.n_agents, cfg.obs_dim)
    assert bool(torch.isfinite(out.obs).all()) and bool(torch.isfinite(out.reward).all())
    assert float(states.pos.abs().sum()) > 0.0  # the actions moved the agents


def _from_jax(js):
    """The port's EnvState holding a JAX batch state (its PRNG keys dropped)."""
    return EnvState(**{f: torch.from_numpy(np.array(getattr(js, f)))
                       for f in ("pos", "vel", "poi_pos", "poi_vel", "energy", "poi_done", "t")})


def _mode_actions(mode, rng, shape):
    """Random actions of ``mode``: discrete indices as floats with fractions
    (both packages truncate to int32), mixed throttles on and off .5."""
    if mode == "discrete":
        return (rng.integers(0, 5, shape + (1,)) + rng.uniform(0, 0.99, shape + (1,))).astype(
            np.float32)
    if mode == "multi_discrete":
        return rng.integers(0, 3, shape + (2,)).astype(np.float32)
    if mode == "multi_binary":
        return rng.integers(0, 2, shape + (4,)).astype(np.float32)
    if mode == "mixed":
        box = rng.uniform(-1, 1, shape + (2,))
        # throttle indices exactly on .5 (half to even: 0.5 -> 0, 1.5 -> 2)
        # and between
        thr = rng.choice([0.5, 1.5, 0.2, 1.0, 1.7], shape + (1,))
        return np.concatenate([box, thr], -1).astype(np.float32)
    return rng.uniform(-1, 1, shape + (2,)).astype(np.float32)


@pytest.mark.parametrize("mode", ["continuous", "discrete", "multi_discrete",
                                  "multi_binary", "mixed"])
def test_action_modes_match_jax_across_auto_reset(mode):
    """Every action mode's decode, stepped from JAX's states with the same
    actions, across real dones and time-limit resets (the f32 tolerances of
    test_step_batch_matches_jax_across_auto_reset)."""
    kw = dict(max_ep_len=30, time_limit=True, action_mode=mode)
    jcfg, cfg = JEnvConfig(**kw), EnvConfig(**kw)
    assert (cfg.action_dim, cfg.action_head_kind, cfg.action_head_dims) == (
        jcfg.action_dim, jcfg.action_head_kind, jcfg.action_head_dims)
    E, steps = 5, 70
    rng = np.random.default_rng(1)
    actions = _mode_actions(mode, rng, (steps, E, cfg.n_agents))
    assert actions.shape[-1] == cfg.action_width
    js = j_reset_batch(jcfg, jax.random.PRNGKey(0), E)
    ts = _from_jax(js)
    n_done = 0
    for a in actions:
        js, jo = j_step_batch(jcfg, js, jnp.asarray(a))
        ts, to = step_batch(cfg, ts, torch.from_numpy(a))
        np.testing.assert_allclose(to.obs.numpy(), np.asarray(jo.obs), atol=1e-5)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.truncated.numpy(), np.asarray(jo.truncated))
        n_done += int(to.done.sum() + to.truncated.sum())
    assert n_done > 0


def test_mixed_throttle_rounds_half_to_even():
    cfg = EnvConfig(action_mode="mixed")
    a = torch.tensor([[[1.0, -1.0, 0.5], [1.0, 0.0, 1.5], [0.5, 0.5, 2.5], [1.0, 1.0, 0.49]]])
    force = decode_action(cfg, a, torch.float32)
    assert np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5, 0.49]))).tolist() == [0, 2, 2, 0]
    np.testing.assert_array_equal(
        force[0].numpy(), [[0.5, -0.5], [1.5, 0.0], [0.75, 0.75], [0.5, 0.5]])


@pytest.mark.parametrize(
    "kw",
    [dict(randomize_pois=True, poi_speed=0.1, collision_penalty=10.0),
     dict(poi_speed=0.3), dict(collision_penalty=10.0, comm_force_scale=5.0)],
    ids=["moving-collision", "fast-pois", "collision-connect"],
)
def test_env_extensions_match_jax_across_auto_reset(kw):
    """Moving PoIs (drift, bounce at +-1, clip) and the collision penalty,
    each step taken by both packages from JAX's state with the same actions
    (f32 tolerances as above). Where an episode ends each package redraws
    the layout from its own random source, so there the fresh state is held
    to what a reset gives: agents at the origin at rest, zero energy, PoIs
    in [-1, 1] moving at poi_speed, and the observation of that state."""
    kw = dict(max_ep_len=25, time_limit=True, n_agents=3, n_pois=8, **kw)
    jcfg, cfg = JEnvConfig(**kw), EnvConfig(**kw)
    E, steps = 6, 60
    rng = np.random.default_rng(2)
    actions = rng.uniform(-1, 1, (steps, E, cfg.n_agents, 2)).astype(np.float32)
    actions[:, 0] = [1.0, 0.0]  # env 0 flies out: a real done before the time limit
    gen = torch.Generator().manual_seed(0)
    js = j_reset_batch(jcfg, jax.random.PRNGKey(0), E)
    n_reset = n_bounce = 0
    for a in actions:
        ts = _from_jax(js)
        js, jo = j_step_batch(jcfg, js, jnp.asarray(a))
        ts, to = step_batch(cfg, ts, torch.from_numpy(a), gen)
        np.testing.assert_allclose(to.reward.numpy(), np.asarray(jo.reward),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(to.done.numpy(), np.asarray(jo.done))
        np.testing.assert_array_equal(to.truncated.numpy(), np.asarray(jo.truncated))
        reset = (to.done | to.truncated).numpy()
        keep = ~reset
        jkeep = _from_jax(js)
        for f in ("pos", "vel", "poi_pos", "poi_vel", "energy", "poi_done", "t"):
            np.testing.assert_allclose(getattr(ts, f)[keep].float().numpy(),
                                       np.asarray(getattr(jkeep, f))[keep].astype(np.float32),
                                       atol=1e-5, err_msg=f)
        np.testing.assert_allclose(to.obs[keep].numpy(), np.asarray(jo.obs)[keep], atol=1e-5)
        if reset.any():
            r = torch.from_numpy(reset)
            assert float(ts.pos[r].abs().max()) == float(ts.vel[r].abs().max()) == 0.0
            assert float(ts.energy[r].abs().max()) == 0.0 and int(ts.t[r].max()) == 0
            assert float(ts.poi_pos[r].abs().max()) <= 1.0
            speed = ts.poi_vel[r].norm(dim=-1)
            np.testing.assert_allclose(speed.numpy(), cfg.poi_speed, atol=1e-6)
            np.testing.assert_allclose(to.obs[r].numpy(), observation(cfg, ts)[r].numpy())
            n_reset += int(reset.sum())
        n_bounce += int((np.abs(np.asarray(jkeep.poi_pos)) >= 1.0).sum())
    assert n_reset > 0
    if cfg.poi_speed > 0.2:
        assert n_bounce > 0  # the PoIs reached the box and bounced


def test_collision_penalty_counts_close_pairs():
    """Agents at the origin collide pairwise: the penalty takes each of the
    N (N - 1) / 2 pairs once per agent, as JAX's."""
    kw = dict(n_agents=3, n_pois=4, collision_penalty=10.0)
    base = step(EnvConfig(**{**kw, "collision_penalty": 0.0}), reset(EnvConfig(**kw), 1,
                device="cpu"), torch.zeros(1, 3, 2))[1].reward
    _, out = step(EnvConfig(**kw), reset(EnvConfig(**kw), 1, device="cpu"), torch.zeros(1, 3, 2))
    js = j_reset_batch(JEnvConfig(**kw), jax.random.PRNGKey(0), 1)
    _, jo = j_step_batch(JEnvConfig(**kw), js, jnp.zeros((1, 3, 2)))
    assert float(base - out.reward) == pytest.approx(3 * 10.0 * 3)
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(jo.reward), rtol=1e-6)


def test_random_reset_draws():
    """Reset draws lie in range, every env gets its own layout, every reset
    a new one, and the generator makes them reproducible."""
    cfg = EnvConfig(randomize_pois=True, poi_speed=0.1)
    with pytest.raises(ValueError, match="generator"):
        reset_batch(cfg, 2, device="cpu")
    a = reset_batch(cfg, 64, device="cpu", generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    b = reset_batch(cfg, 64, device="cpu", generator=gen)
    c = reset_batch(cfg, 64, device="cpu", generator=gen)
    assert torch.equal(a.poi_pos, b.poi_pos) and torch.equal(a.poi_vel, b.poi_vel)
    assert not torch.equal(b.poi_pos, c.poi_pos)
    assert float(a.poi_pos.abs().max()) <= 1.0 and float(a.poi_pos.min()) < -0.9
    assert len({tuple(p.flatten().tolist()) for p in a.poi_pos}) == 64
    np.testing.assert_allclose(a.poi_vel.norm(dim=-1).numpy(), 0.1, atol=1e-6)
    heading = torch.atan2(a.poi_vel[..., 1], a.poi_vel[..., 0])
    assert float(heading.min()) < -3.0 and float(heading.max()) > 3.0  # all around
    # the deterministic default reset takes no generator and draws nothing
    d = reset_batch(EnvConfig(), 2, device="cpu")
    assert float(d.poi_vel.abs().max()) == 0.0
