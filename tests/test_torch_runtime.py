"""The port's runtime: CLI, config loading, exact checkpoint resume, the
import boundary (no JAX, no dcc_tpu), and no silent CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

from dcc_tpu.configs import load as j_load
from dcc_tpu_torch import train
from dcc_tpu_torch.algos import MAPPO, MAPPOConfig
from dcc_tpu_torch.configs import load
from dcc_tpu_torch.envs import EnvConfig, reset_batch
from dcc_tpu_torch.models import valuenorm as VN
from dcc_tpu_torch.runtime import Learner
from dcc_tpu_torch.utils import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT)


def test_cli_trains_on_cpu(tmp_path):
    # the default model, with a shorter episode and fewer epochs to keep the
    # CPU run short
    out = subprocess.run(
        [sys.executable, "-m", "dcc_tpu_torch.train", "--device", "cpu", "--n-iters", "2",
         "--n-rollout-threads", "4", "--save-gifs", "false", "--max-ep-len", "30",
         "--ppo-epoch", "3"],
        cwd=tmp_path, env=ENV, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "iter: 2" in out.stdout and "phase timing" in out.stdout


@pytest.mark.parametrize("overrides", [{}, {"num_agents": 5, "algo_hidden_size": 64,
                                             "compute_dtype": "bfloat16", "seed": 3}])
def test_config_loading_matches_jax(overrides):
    cfg, env_cfg, algo_cfg = load(overrides)
    jcfg, jenv, jalgo = j_load(overrides)
    assert cfg == jcfg
    assert env_cfg._asdict() == jenv._asdict()
    assert algo_cfg._asdict() == jalgo._asdict()


def _state(ts):
    sd = {f"a.{k}": v for k, v in ts.actor.state_dict().items()}
    sd.update({f"c.{k}": v for k, v in ts.critic.state_dict().items()})
    for name, opt in (("ao", ts.actor_opt), ("co", ts.critic_opt)):
        for i, st in opt.state_dict()["state"].items():
            sd.update({f"{name}.{i}.{k}": v for k, v in st.items()})
    for name, st in (("vn", ts.vnorm), ("pa", ts.popart)):
        sd.update({f"{name}.{i}": v for i, v in enumerate(st or ())})
    sd["gen"] = ts.generator.get_state()
    return sd, (ts.update_count, ts.iteration)


# the PopArt statistics round-trip too (with 2 minibatches, whose
# permutations come from the checkpointed generator)
@pytest.mark.parametrize(
    "extra", [{}, dict(use_popart=True, use_valuenorm=False, num_mini_batch=2)],
    ids=["default", "popart-nmb2"])
def test_checkpoint_resume_is_exact(tmp_path, extra):
    overrides = dict(
        n_iters=3, n_rollout_threads=2, n_eval_rollout_threads=0, max_ep_len=5,
        ppo_epoch=2, save_interval=1, save_gifs=False, algo_hidden_size=32,
        main_save_path=str(tmp_path), **extra,
    )
    l1 = Learner(overrides, device="cpu")
    l1.train()
    path = os.path.join(l1.output_path, "models_1.pt")
    l2 = Learner({**overrides, "load_model": True, "load_model_path": path},
                 device="cpu")
    steps = 2 * extra.get("num_mini_batch", 1)  # optimizer steps an iteration
    assert (l2.ts.update_count, l2.ts.iteration) == (steps, 1)
    # resumed at iteration 1, two more iterations land exactly on l1's state
    for _ in range(2):
        l2.algo.train_iteration(l2.ts)
    (s1, c1), (s2, c2) = _state(l1.ts), _state(l2.ts)
    assert c1 == c2 == (3 * steps, 3)
    assert set(s1) == set(s2)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def test_port_imports_no_jax():
    code = (
        "import importlib, importlib.util, pkgutil, sys, dcc_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(dcc_tpu_torch.__path__, 'dcc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('run_torch_curve',\n"
        "                                              'scripts/run_torch_curve.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dcc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('dcc_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) >= 20  # every module was imported


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAPPO(MAPPOConfig(), EnvConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reset_batch(EnvConfig(), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VN.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--n-iters", "1", "--save-gifs", "false", "--save-model", "false"])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize(
    "overrides,kw",
    [
        ({"n_iters": 2, "render_interval": 1}, {}),  # save_gifs defaults to true
        ({"save_gifs": False}, {"use_mesh": True}),
        ({"save_gifs": False, "algo_file": "maddpg"}, {}),
        ({"save_gifs": False, "profile_dir": "trace"}, {}),
    ],
)
def test_learner_refuses_unported_features(tmp_path, overrides, kw):
    """Trace capture is refused. Rendering, MADDPG and meshes, refused until
    the port ran them, now build a Learner that renders
    (tests/test_torch_render.py writes its GIF), one that trains MADDPG
    (tests/test_torch_maddpg.py trains it) and, in one process, one whose
    ``use_mesh`` leaves the mesh off, as JAX's on one device (2 ranks train
    in tests/test_torch_distributed.py)."""
    overrides = {**overrides, "main_save_path": str(tmp_path)}
    if kw.get("use_mesh"):
        learner = Learner(overrides, device="cpu", **kw)
        assert learner.mesh is None and learner.algo.mesh is None
        return
    if "render_interval" in overrides:
        learner = Learner(overrides, device="cpu", **kw)
        assert learner.output_path and os.path.isdir(learner.output_path)
        assert learner.cfg["save_gifs"] and learner.cfg["render_interval"] == 1
        return
    if overrides.get("algo_file") == "maddpg":
        learner = Learner(overrides, device="cpu", **kw)
        assert type(learner.algo).__name__ == "MADDPG"
        assert learner.algo_cfg is learner.algo.cfg
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Learner(overrides, device="cpu", **kw)
