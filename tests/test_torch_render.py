"""The port's renderer against ``dcc_tpu.render``: ``draw_frame`` pixel for
pixel on the same states (both draw with Pillow, call for call),
``render_gif``'s frame count and tiling (as tests/test_runtime.py), the
written GIF decoded back to the frames exactly, ``rollout_states`` in
deterministic mode against JAX's from converted parameters (atol 1e-4, as
the rollout in tests/test_torch_slice.py), the Learner's ``models_{it}.gif``
from the default command, and ``LiveViewer`` under matplotlib's Agg
backend."""

import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dcc_tpu.algos import MAPPO as JMAPPO
from dcc_tpu.algos import MAPPOConfig as JMAPPOConfig
from dcc_tpu.envs import EnvConfig as JEnvConfig
from dcc_tpu.render.gif import draw_frame as j_draw_frame
from dcc_tpu.render.gif import rollout_states as j_rollout_states
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.envs import EnvConfig
from dcc_tpu_torch.render import LiveViewer, draw_frame, render_gif, rollout_states
from dcc_tpu_torch.runtime import Learner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_rollout_threads=2, episode_length=6, ppo_epoch=1, n_iters=2, hidden_size=32)


def _gif_frames(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return frames


def _states(rng, n, m):
    """Agents close enough for comm links, PoIs at every energy level, some
    done."""
    energy = rng.uniform(0, 6, m).astype(np.float32)
    return (rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32),
            rng.uniform(-1, 1, (m, 2)).astype(np.float32), energy, energy >= 5.0)


@pytest.mark.parametrize("n,m,size", [(4, 20, 700), (10, 20, 128), (3, 10, 233)])
def test_draw_frame_matches_jax_pixel_for_pixel(n, m, size):
    cfg, jcfg = EnvConfig(n_agents=n, n_pois=m), JEnvConfig(n_agents=n, n_pois=m)
    rng = np.random.default_rng(n + size)
    for _ in range(3):
        state = _states(rng, n, m)
        frame = draw_frame(cfg, *state, size=size)
        assert frame.shape == (size, size, 3) and frame.dtype == np.uint8
        assert (frame != 255).any()
        np.testing.assert_array_equal(frame, j_draw_frame(jcfg, *state, size=size))


def _pair():
    jalgo = JMAPPO(JMAPPOConfig(gae_backend="xla", **SMALL), JEnvConfig())
    jts = jalgo.init_state(jax.random.PRNGKey(0))
    algo = MAPPO(MAPPOConfig(**SMALL), EnvConfig(), device="cpu")
    actor, critic = algo.make_networks()
    actor.load_state_dict(flax_to_state_dict(jax.device_get(jts.actor_params)))
    critic.load_state_dict(flax_to_state_dict(jax.device_get(jts.critic_params)))
    return jalgo, jts, algo, algo.init_state(actor=actor, critic=critic)


@pytest.mark.parametrize("n_envs", [1, 3])
def test_rollout_states_match_jax(n_envs):
    jalgo, jts, algo, ts = _pair()
    want = j_rollout_states(jalgo, jts, jax.random.PRNGKey(1), deterministic=True,
                            n_envs=n_envs)
    got = rollout_states(algo, ts, deterministic=True, n_envs=n_envs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].astype(np.float32),
                                   np.asarray(want[k]).astype(np.float32), atol=1e-4,
                                   err_msg=k)


def test_render_frame_and_gif(tmp_path):
    algo = MAPPO(MAPPOConfig(**SMALL), EnvConfig(), device="cpu")
    ts = algo.init_state(0)
    states = rollout_states(algo, ts, torch.Generator().manual_seed(1))
    assert states["pos"].shape == (7, 4, 2) and states["reward"].shape == (6,)
    gif = str(tmp_path / "ep.gif")
    frames = render_gif(algo.env_cfg, states, gif, size=96)
    assert len(frames) == 7 and frames[0].shape == (96, 96, 3)
    decoded = _gif_frames(gif)
    assert len(decoded) == 7
    for got, want in zip(decoded, frames):
        np.testing.assert_array_equal(got, want)


def test_render_farm_tiles_multi_env(tmp_path):
    """Multi-env states carry an env axis and render_gif tiles the per-env
    frames into one near-square grid, zero padded."""
    algo = MAPPO(MAPPOConfig(**{**SMALL, "episode_length": 4}), EnvConfig(), device="cpu")
    ts = algo.init_state(0)
    states = rollout_states(algo, ts, torch.Generator().manual_seed(1), n_envs=3)
    assert states["pos"].shape == (5, 3, 4, 2) and states["reward"].shape == (4, 3)
    gif = str(tmp_path / "farm.gif")
    frames = render_gif(algo.env_cfg, states, gif, size=64)
    assert len(frames) == 5 and frames[0].shape == (128, 128, 3)
    np.testing.assert_array_equal(
        frames[2][:64, 64:], draw_frame(algo.env_cfg, *(states[k][2, 1] for k in
                                        ("pos", "poi_pos", "energy", "poi_done")), size=64))
    assert not frames[2][64:, 64:].any()  # the fourth tile is padding
    assert len(_gif_frames(gif)) == 5


def test_default_command_writes_the_gif(tmp_path):
    """``python -m dcc_tpu_torch.train`` with the default config on the CPU,
    2 iterations and 2 envs, renders at iteration 2: models_2.gif holds the
    T + 1 = 151 frames of 700 x 700 of one env's episode."""
    out = subprocess.run(
        [sys.executable, "-m", "dcc_tpu_torch.train", "--device", "cpu", "--n-iters", "2",
         "--render-interval", "2", "--n-rollout-threads", "2", "--main-save-path",
         str(tmp_path)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"render"' in out.stdout  # the render phase is timed
    gifs = glob.glob(os.path.join(str(tmp_path), "uav_dcc", "*", "models_*.gif"))
    assert [os.path.basename(g) for g in gifs] == ["models_2.gif"]
    with Image.open(gifs[0]) as im:
        assert im.n_frames == 151 and im.size == (700, 700)


def test_learner_renders_live_under_agg(tmp_path):
    """render_live without save_gifs: the frames (tiled over
    n_render_rollout_threads envs, each ~700 / ceil(sqrt(n)) px) go to the
    viewer and no GIF is written. Under Agg the viewer opens no window."""
    import matplotlib

    matplotlib.use("Agg")
    learner = Learner(dict(n_iters=1, max_ep_len=4, n_rollout_threads=2,
                           n_eval_rollout_threads=0, ppo_epoch=1, algo_hidden_size=32,
                           save_gifs=False, render_live=True, render_interval=1,
                           n_render_rollout_threads=2, main_save_path=str(tmp_path)),
                      device="cpu")
    learner.train()
    viewer = learner._live_viewer
    assert isinstance(viewer, LiveViewer) and not viewer.interactive
    assert viewer.last_frame.shape == (350, 700, 3)  # two 350 px tiles side by side
    assert not glob.glob(os.path.join(learner.output_path, "*.gif"))
    assert learner.timer.summary()["render"]["count"] == 1
