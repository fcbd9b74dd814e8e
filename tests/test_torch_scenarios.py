"""The scenario registry and the `spread` scenario of the port against the
JAX package's.

``spread``'s ``observation`` and ``step`` run from states built from JAX's
reset (the port's reset draws from a ``torch.Generator``, JAX's from a key
per env), at the default and at other entity counts, Box and discrete
actions, with agents pushed past the hard bound and close enough to
collide; f32, held to 1e-6 absolute, the reward to 1e-4: its out-of-bounds
term is 100 N times an agent's distance past the soft bound, so one f32 ulp
of a position (1.2e-7 near 1; XLA fuses the velocity update) moves it by
3.6e-5 at N = 3. ``make_vec_fns``' auto-reset (on done
and on truncation) takes the fresh layout the generator draws. MAPPO and
MADDPG train on ``spread`` through the Learner on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.envs import spread as jspread
from dcc_tpu.envs.vector import make_vec_fns as j_make_vec_fns
from dcc_tpu.configs.loader import load as j_load
from dcc_tpu.render.gif import draw_frame as j_draw_frame
from dcc_tpu_torch.algos import MADDPG, MAPPO, MAPPOConfig
from dcc_tpu_torch.configs.loader import load
from dcc_tpu_torch.envs import (EnvConfig, EnvState, get_scenario, make_vec_fns, observation,
                                register_scenario, reset, step)
from dcc_tpu_torch.envs import spread
from dcc_tpu_torch.render import draw_frame
from dcc_tpu_torch.runtime.learner import Learner

ATOL = 1e-6
REWARD_ATOL = 1e-4  # 100 N x one f32 ulp of a position past the soft bound
SIZES = [(4, 4, False), (3, 5, False), (6, 2, True)]


def _port_states(js) -> EnvState:
    t = lambda x: torch.tensor(np.asarray(x))
    return EnvState(pos=t(js.pos), vel=t(js.vel), poi_pos=t(js.poi_pos), poi_vel=t(js.poi_vel),
                    energy=t(js.energy), poi_done=t(js.poi_done), t=t(js.t).to(torch.int32))


def _jax_states(n_agents, n_landmarks, discrete, n_envs=6):
    """JAX's reset of ``n_envs`` envs, with env 0's first agent 0.01 from
    the hard bound and env 1's first two agents 0.05 apart; and the config."""
    cfg = jspread.SpreadConfig(n_agents=n_agents, n_landmarks=n_landmarks,
                               discrete_actions=discrete, max_ep_len=5)
    js = jax.vmap(lambda k: jspread.reset(cfg, k))(jax.random.split(jax.random.PRNGKey(3),
                                                                    n_envs))
    pos = js.pos.at[0, 0].set(jnp.array([1.49, 0.3], jnp.float32))
    pos = pos.at[1, 1].set(pos[1, 0] + 0.05)
    vel = js.vel.at[0, 0].set(jnp.array([0.5, 0.0], jnp.float32))
    return cfg, js.replace(pos=pos, vel=vel)


def _actions(cfg, n_envs, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.discrete_actions:
        return rng.integers(0, 5, (n_envs, cfg.n_agents, 1)).astype(np.float32)
    return rng.uniform(-1, 1, (n_envs, cfg.n_agents, 2)).astype(np.float32)


def _port_cfg(jcfg) -> spread.SpreadConfig:
    return spread.SpreadConfig(**jcfg._asdict())


def test_registry_roundtrip():
    sc = get_scenario("coverage")
    assert sc["config_cls"] is EnvConfig
    assert sc["reset"] is reset and sc["step"] is step and sc["observation"] is observation
    assert get_scenario("spread")["config_cls"] is spread.SpreadConfig
    with pytest.raises(KeyError, match="registered: .*'coverage'.*'spread'"):
        get_scenario("no_such_scenario")
    register_scenario("toy", config_cls=EnvConfig, reset_fn=reset, step_fn=step,
                      observation_fn=observation)
    assert get_scenario("toy")["step"] is step
    with pytest.raises(ValueError, match="already registered"):
        register_scenario("toy", config_cls=EnvConfig, reset_fn=reset, step_fn=step,
                          observation_fn=observation)
    with pytest.raises(ValueError, match="already registered"):
        register_scenario("spread", config_cls=EnvConfig, reset_fn=reset, step_fn=step,
                          observation_fn=observation)


@pytest.mark.parametrize("n_agents,n_landmarks,discrete", SIZES)
def test_spread_observation_and_step_match_jax(n_agents, n_landmarks, discrete):
    jcfg, js = _jax_states(n_agents, n_landmarks, discrete)
    cfg = _port_cfg(jcfg)
    assert (cfg.obs_dim, cfg.action_dim) == (jcfg.obs_dim, jcfg.action_dim)
    st = _port_states(js)
    np.testing.assert_allclose(spread.observation(cfg, st),
                               jax.vmap(lambda s: jspread.observation(jcfg, s))(js), atol=ATOL)
    act = _actions(jcfg, 6)
    jstep = jax.jit(jax.vmap(lambda s, a: jspread.step(jcfg, s, a)))
    for t in range(3):  # three steps: collisions, the hard bound, the occupied landmarks
        js, jout = jstep(js, jnp.asarray(act))
        st, out = spread.step(cfg, st, torch.tensor(act))
        for k in ("obs", "reward", "coverage_rate"):
            np.testing.assert_allclose(getattr(out, k), getattr(jout, k), rtol=1e-6,
                                       atol=REWARD_ATOL if k == "reward" else ATOL,
                                       err_msg=f"step {t}: {k}")
        for k in ("done", "truncated"):
            np.testing.assert_array_equal(getattr(out, k), getattr(jout, k), err_msg=k)
        for k in ("pos", "vel", "energy", "poi_done", "t"):
            np.testing.assert_allclose(getattr(st, k), getattr(js, k), atol=ATOL, err_msg=k)
    assert bool(out.done[0])  # env 0 left the hard bound
    assert not discrete or cfg.action_width == 1


def test_spread_vec_auto_reset():
    """``make_vec_fns("spread")``: an env resets on done (env 0 leaves the
    hard bound) and on truncation (all at t = max_ep_len), to the fresh
    layout the generator draws; reward, done and truncated describe the
    step before the reset, as JAX's batched step."""
    jcfg, js = _jax_states(4, 4, False)
    cfg = _port_cfg(jcfg)
    js = js.replace(t=js.t.at[2:].set(jcfg.max_ep_len - 1))
    reset_b, step_b = make_vec_fns("spread")
    gen = torch.Generator().manual_seed(0)
    fresh = reset_b(cfg, 6, device="cpu", generator=torch.Generator().manual_seed(0))
    act = _actions(jcfg, 6)
    st, out = step_b(cfg, _port_states(js), torch.tensor(act), gen)
    _, jout = jax.jit(j_make_vec_fns("spread")[1], static_argnums=0)(jcfg, js, jnp.asarray(act))
    np.testing.assert_array_equal(out.done, jout.done)
    np.testing.assert_array_equal(out.truncated, jout.truncated)
    np.testing.assert_allclose(out.reward, jout.reward, atol=REWARD_ATOL, rtol=1e-6)
    boundary = (out.done | out.truncated).numpy()
    assert boundary.tolist() == [True, False, True, True, True, True]
    for i in range(6):
        if boundary[i]:
            assert torch.equal(st.pos[i], fresh.pos[i]) and int(st.t[i]) == 0
            assert torch.equal(st.poi_pos[i], fresh.poi_pos[i])
        else:  # no reset: JAX's step
            np.testing.assert_allclose(out.obs[i], jout.obs[i], atol=ATOL)
    torch.testing.assert_close(out.obs, spread.observation(cfg, st))


def test_loader_routes_spread_like_jax():
    overrides = dict(scenario_name="spread", num_agents=3, num_landmarks=5, max_ep_len=9)
    cfg, env_cfg, algo_cfg = load(overrides)
    _, jenv_cfg, _ = j_load(overrides)
    assert isinstance(env_cfg, spread.SpreadConfig)
    assert env_cfg._asdict() == jenv_cfg._asdict()
    assert isinstance(algo_cfg, MAPPOConfig)
    with pytest.raises(KeyError, match="unknown scenario 'nope'"):
        load(dict(scenario_name="nope"))


def test_mappo_refuses_what_jax_refuses():
    cfg = _port_cfg(jspread.SpreadConfig())
    with pytest.raises(NotImplementedError, match="plumbed for the coverage"):
        MAPPO(MAPPOConfig(env_dtype="float64"), cfg, device="cpu", scenario="spread")


def test_spread_frame_matches_jax():
    """The renderer's fallbacks for a config without coverage's fields."""
    jcfg, js = _jax_states(3, 5, False)
    cfg = _port_cfg(jcfg)
    args = [np.asarray(x[0]) for x in (js.pos, js.poi_pos, js.energy, js.poi_done)]
    np.testing.assert_array_equal(draw_frame(cfg, *args, size=128),
                                  np.asarray(j_draw_frame(jcfg, *args, size=128)))


RUN = dict(scenario_name="spread", num_agents=3, num_landmarks=3, n_iters=2,
           n_rollout_threads=2, n_eval_rollout_threads=2, max_ep_len=6, eval_interval=1,
           render_interval=2, save_interval=2, save_gifs=True)


@pytest.mark.parametrize("algo", ["mappo", "maddpg"])
def test_trains_on_spread_through_the_learner(tmp_path, algo):
    """scenario_name spread through loader -> factory -> trainer -> batched
    env -> eval -> render -> checkpoint, as the JAX package's Learner."""
    extra = dict(ppo_epoch=1) if algo == "mappo" else dict(
        batch_size=8, buffer_capacity=32, warmup_steps=4, updates_per_iter=2,
        hidden_sizes_mlp=[8])
    learner = Learner(dict(RUN, algo_file=algo, main_save_path=str(tmp_path), **extra),
                      device="cpu")
    assert isinstance(learner.algo, MAPPO if algo == "mappo" else MADDPG)
    assert learner.algo.scenario == "spread"
    assert isinstance(learner.env_cfg, spread.SpreadConfig)
    learner.train()
    assert learner.ts.iteration == 2
    m = learner.last_metrics
    m = m._asdict() if hasattr(m, "_asdict") else m
    assert all(np.isfinite(v) for v in m.values())
    for name in ("models_2.gif", "models_2.pt"):
        assert (tmp_path / "uav_dcc" / learner.output_path.split("/")[-1] / name).exists()
