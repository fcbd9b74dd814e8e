"""The gym-style facades, spaces and debug policies of the port against the
JAX package's (``dcc_tpu.envs.facade``, ``spaces``, ``policy``).

``DCEnv`` and ``VecDCEnv`` take the same action sequences as JAX's (numpy
in, numpy out): observations, rewards, dones and coverage rates held to
1e-5 absolute in f32 over 12 steps (positions drift by f32 ulps, and the
observation carries them), and the auto-reset of ``VecDCEnv`` on
truncation (``time_limit`` with 5-step episodes). The spaces of every
action mode match JAX's; the heuristic policy's actions on the same
observations are JAX's.
"""

import io

import numpy as np
import pytest

from dcc_tpu.envs import DCEnv as JDCEnv
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.envs import HeuristicCoveragePolicy as JHeuristic
from dcc_tpu.envs import VecDCEnv as JVecDCEnv
from dcc_tpu.envs.facade import _make_spaces as j_make_spaces
from dcc_tpu_torch.envs import (Box, DCEnv, Discrete, EnvConfig, HeuristicCoveragePolicy,
                                InteractivePolicy, MultiBinary, MultiDiscrete, TupleSpace,
                                VecDCEnv)
from dcc_tpu_torch.envs.facade import _make_spaces

ATOL = 1e-5
MODES = ["continuous", "discrete", "multi_discrete", "multi_binary", "mixed"]


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=1e-6, err_msg=what)


def test_dcenv_matches_jax():
    kw = dict(n_agents=3, n_pois=8, r_cover=0.3)
    env, jenv = DCEnv(seed=0, device="cpu", **kw), JDCEnv(seed=0, **kw)
    assert isinstance(env.cfg, EnvConfig) and env.max_ep_len == jenv.max_ep_len
    _close(env.reset(), jenv.reset(), "reset obs")
    rng = np.random.default_rng(1)
    for t in range(12):
        act = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
        (o, r, d, info), (jo, jr, jd, jinfo) = env.step(act), jenv.step(act)
        assert o.shape == (3, env.cfg.obs_dim) and r.shape == d.shape == (3,)
        _close(o, jo, f"obs {t}")
        _close(r, jr, f"reward {t}")
        np.testing.assert_array_equal(d, jd)
        assert abs(info["coverage_rate"] - jinfo["coverage_rate"]) < 1e-6
    np.testing.assert_array_equal(env.render(), jenv.render())


def test_vec_dcenv_matches_jax_with_auto_reset():
    kw = dict(n_agents=4, n_pois=6, time_limit=True, max_ep_len=5)
    env, jenv = VecDCEnv(n_envs=3, seed=0, device="cpu", **kw), JVecDCEnv(n_envs=3, seed=0, **kw)
    _close(env.reset(), jenv.reset(), "reset obs")
    rng = np.random.default_rng(2)
    for t in range(12):  # episodes end at steps 5 and 10: the reset observation comes back
        act = rng.uniform(-1, 1, (3, 4, 2)).astype(np.float32)
        (o, r, d, infos), (jo, jr, jd, jinfos) = env.step(act), jenv.step(act)
        assert o.shape == (3, 4, env.cfg.obs_dim) and r.shape == (3, 4, 1) and d.shape == (3, 4)
        _close(o, jo, f"obs {t}")
        _close(r, jr, f"reward {t}")
        np.testing.assert_array_equal(d, jd)
        _close([i["coverage_rate"] for i in infos], [i["coverage_rate"] for i in jinfos], "cov")
        if t in (4, 9):  # the step that truncated: agents back at the origin
            assert np.all(o[:, :, 2:4] == 0.0)
    frames = env.render(mode="rgb_array", size=64)
    assert frames.shape == (3, 64, 64, 3)
    assert env.render(size=64).shape == (128, 128, 3)  # 3 envs tiled 2 x 2


def test_vec_dcenv_random_reset_draws_from_its_seed():
    kw = dict(n_agents=2, n_pois=4, randomize_pois=True)
    a, b = (VecDCEnv(n_envs=2, seed=5, device="cpu", **kw) for _ in range(2))
    np.testing.assert_array_equal(a.reset(), b.reset())
    assert not np.array_equal(a.reset(), b.reset()[::-1])


@pytest.mark.parametrize("mode", MODES)
def test_spaces_match_jax(mode):
    obs, act, share = _make_spaces(EnvConfig(action_mode=mode))
    jobs, jact, jshare = j_make_spaces(JEnvConfig(action_mode=mode))
    for got, want in ((obs, jobs), (act, jact), (share, jshare)):
        assert [repr(s) for s in got] == [repr(s) for s in want]
        assert [s.shape for s in got] == [s.shape for s in want]
    space = act[0]
    rng = np.random.RandomState(0)
    for _ in range(5):
        assert space.contains(space.sample(rng))
    kind = {"continuous": Box, "discrete": Discrete, "multi_discrete": MultiDiscrete,
            "multi_binary": MultiBinary, "mixed": TupleSpace}[mode]
    assert isinstance(space, kind)
    if mode == "multi_discrete":
        assert space.n == 6 and not space.contains(np.array([3, 0]))


def test_heuristic_policy_matches_jax():
    kw = dict(n_agents=4, n_pois=20)
    env = DCEnv(seed=0, device="cpu", **kw)
    pol, jpol = HeuristicCoveragePolicy(4, 20), JHeuristic(4, 20)
    obs = env.reset()
    for _ in range(20):
        act = pol.action(obs)
        np.testing.assert_array_equal(act, jpol.action(obs))
        assert act.dtype == np.float32 and np.all(np.linalg.norm(act, axis=-1) <= 1.0 + 1e-6)
        obs, _, _, info = env.step(act)
    assert info["coverage_rate"] > 0.0  # the heuristic covers PoIs


def test_interactive_policy_reads_commands():
    pol = InteractivePolicy(n_agents=3, agent_idx=1, stream=io.StringIO("w\nd\nx\n"))
    want = [(0.0, 1.0), (1.0, 0.0), (0.0, 0.0)]
    for vec in want:
        act = pol.action(None)
        assert act.shape == (3, 2) and tuple(act[1]) == vec
        assert not act[[0, 2]].any()
