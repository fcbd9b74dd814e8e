"""Learner: the train / eval / save / log cadence around the trainer that
``algo_file`` selects (MAPPO or MADDPG, :func:`~dcc_tpu_torch.algos.make_algo`)
on the scenario that ``scenario_name`` selects.

Counterpart of :class:`dcc_tpu.runtime.learner.Learner`. Run artifacts go to
``<main_save_path>/<save_name>/<MMDD_HHMM_sd{seed}>/`` with a ``config.json``
snapshot. Every ``render_interval`` iterations, with ``save_gifs`` or
``render_live`` and a saved model, it renders an episode of
``n_render_rollout_threads`` envs, tiled, to ``models_{it}.gif`` (and shows
it live), timed as the ``render`` phase; a separated policy with rendering
on raises at construction, since the JAX package cannot render one either.
Device-trace capture is not ported yet: a config that asks for it raises at
construction instead of skipping it.

Several processes (one rank a device, joined by
:func:`dcc_tpu_torch.parallel.distributed.initialize`) train as one with
``use_mesh``: the envs split over the ranks, the parameters replicated
(counterpart of ``dcc_tpu.runtime.learner`` with its ``--mesh``; in one
process ``use_mesh`` leaves the mesh off, as JAX's on one device). The
coordinator alone makes the host's side effects: the run dir (its name
broadcast to the other ranks), ``config.json``, wandb, the console log,
render and GIFs, and the checkpoint files, which every rank meets at a
barrier.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..algos import make_algo
from ..configs.loader import load as load_config
from ..parallel import distributed, make_mesh
from ..render import LiveViewer, render_gif, rollout_states
from ..utils import resolve_device
from ..utils.profiling import PhaseTimer
from . import checkpoint as ckpt


class Learner:
    def __init__(
        self,
        overrides: Optional[Dict[str, Any]] = None,
        use_mesh: bool = False,
        env_yaml: Optional[str] = None,
        algo_yaml: Optional[str] = None,
        expt_yaml: Optional[str] = None,
        device: Optional[str] = None,
    ):
        self.cfg, self.env_cfg, self.algo_cfg = load_config(
            overrides, env_yaml=env_yaml, algo_yaml=algo_yaml, expt_yaml=expt_yaml
        )
        cfg = self.cfg
        self.seed = int(cfg.get("seed", 0))
        self.n_iters = int(cfg.get("n_iters", 200))
        self.is_save_model = bool(cfg.get("save_model", True))
        algo_file = str(cfg.get("algo_file", "mappo"))
        if cfg.get("profile_dir"):
            raise NotImplementedError(
                "device-trace capture (profile_dir) is not ported yet (ROADMAP: "
                "torch.profiler trace window)"
            )

        renders = bool(cfg.get("save_gifs", True)) or bool(cfg.get("render_live", False))
        if "mappo" in algo_file and not self.algo_cfg.share_policy and self.is_save_model \
                and renders:
            # JAX's render passes the stacked per-agent parameters to one actor
            # and fails after training (flax ScopeParamShapeError at
            # dcc_tpu/render/gif.py:58)
            raise ValueError(
                "separated policies cannot be rendered (the JAX package's render fails "
                "with flax's ScopeParamShapeError at dcc_tpu/render/gif.py:58): pass "
                "--save-gifs false (and no --render-live)"
            )
        self.device = resolve_device(device)
        # join the process group when launched as one of several ranks
        # (no-op in one process); a rank's device is its local one
        distributed.initialize(backend="nccl" if self.device.type == "cuda" else "gloo")
        self.is_coordinator = distributed.is_coordinator()
        if distributed.process_count() > 1 and self.device.type == "cuda":
            self.device = torch.device("cuda", distributed.local_rank())
        self.mesh = (make_mesh(self.device)
                     if use_mesh and distributed.process_count() > 1 else None)
        if self.device.type == "cuda":
            # f32 means full f32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.algo = make_algo(cfg, self.env_cfg, device=self.device, mesh=self.mesh)
        self.algo_cfg = self.algo.cfg
        self.ts = self.algo.init_state(self.seed)
        self.n_eval = int(cfg.get("n_eval_rollout_threads", 16))

        self.output_path = None
        if self.is_save_model:
            name = None
            if self.is_coordinator:
                name = datetime.datetime.now().strftime("%m%d_%H%M_") + f"sd{self.seed}"
            self.output_path = os.path.join(
                str(cfg.get("main_save_path", "results/")),
                str(cfg.get("save_name", "uav_dcc")),
                distributed.broadcast_str(name),
            )
            if self.is_coordinator:
                os.makedirs(self.output_path, exist_ok=True)
                with open(os.path.join(self.output_path, "config.json"), "w") as f:
                    json.dump(cfg, f, indent=4, default=str)

        if cfg.get("load_model") and cfg.get("load_model_path"):
            self.load_model(str(cfg["load_model_path"]))
            if self.is_coordinator:
                print("!!!!!Note: Load model, done!!!!!")

        self.timer = PhaseTimer()
        self._live_viewer = None
        self._wandb = None
        if bool(cfg.get("log_wandb", False)) and self.is_coordinator:
            try:
                import wandb
            except ImportError as e:
                print(f"wandb unavailable ({e}); console logging only")
            else:
                self._wandb = wandb
                wandb.init(
                    project=str(cfg.get("save_name", "uav_dcc")),
                    group=algo_file,
                    name=os.path.basename(self.output_path or "run"),
                    config=cfg,
                )
        self._start = self._check = time.time()

    def train(self):
        cfg = self.cfg
        eval_interval = int(cfg.get("eval_interval", 10))
        save_interval = int(cfg.get("save_interval", 50))
        log_interval = int(cfg.get("log_interval", 1))
        render_interval = int(cfg.get("render_interval", 200))
        renders = bool(cfg.get("save_gifs", True)) or bool(cfg.get("render_live", False))
        for it in range(1, self.n_iters + 1):
            with self.timer.phase("train"):
                m = self.algo.train_iteration(self.ts, timer=self.timer)
            self.last_metrics = m
            logs: Dict[str, Dict[str, float]] = {}
            if it % log_interval == 0:
                # MAPPO returns Metrics, MADDPG a dict: both split into the
                # rollout_info / rl_train_info sections
                md = m._asdict() if hasattr(m, "_asdict") else dict(m)
                logs["rollout_info"] = {k: md.pop(k) for k in ("reward", "coverage_rate")}
                logs["rl_train_info"] = md
            if self.n_eval > 0 and it % eval_interval == 0:
                with self.timer.phase("eval"):
                    gen = torch.Generator(device=self.device).manual_seed(
                        self.seed + 10_000 + it
                    )
                    logs["test_rollout_info"] = self.algo.eval_iteration(
                        self.ts, self.n_eval, generator=gen
                    )
            if renders and self.output_path and self.is_coordinator \
                    and it % render_interval == 0:
                with self.timer.phase("render"):
                    self.render(os.path.join(self.output_path, f"models_{it}.gif"))
            if logs:
                self.log(it, logs)
            if self.is_save_model and it % save_interval == 0:
                with self.timer.phase("save"):
                    path = os.path.join(self.output_path, f"models_{it}.pt")
                    self.save_model(path)
                if self.is_coordinator:
                    print(f"model saved in {path}")
        if self.is_coordinator:
            print("phase timing:", json.dumps(self.timer.summary()))
        if self._wandb is not None:
            self._wandb.finish()

    def render(self, path: str) -> dict:
        """Roll ``n_render_rollout_threads`` envs (sampled actions from a
        generator of the seed), draw the frames tiled, each env's frame 700
        px or, with more envs, smaller so the grid stays about 700 px (at
        least 128), write them to ``path`` when ``save_gifs`` and show them
        when ``render_live``. Returns the rollout's states."""
        cfg = self.cfg
        n_render = max(1, int(cfg.get("n_render_rollout_threads", 1)))
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 99)
        states = rollout_states(self.algo, self.ts, gen, n_envs=n_render)
        size = 700 if n_render == 1 else max(128, 700 // int(np.ceil(np.sqrt(n_render))))
        gif_path = path if cfg.get("save_gifs", True) else None
        frames = render_gif(self.env_cfg, states, gif_path, size=size)
        if cfg.get("render_live", False):
            if self._live_viewer is None:
                self._live_viewer = LiveViewer(title="dcc_tpu_torch training")
            for frame in frames:
                self._live_viewer.show(frame)
        return states

    def log(self, it: int, logs: Dict[str, Dict[str, float]]):
        if self._wandb is not None:
            for d in logs.values():
                self._wandb.log(d, step=it)
        if not self.is_coordinator:
            return
        now = time.time()
        print(
            f"******** iter: {it}, iter_time: {now - self._check:.2f}s, "
            f"total_time: {now - self._start:.2f}s"
        )
        for key, d in logs.items():
            print(key + "".join(f", {k}: {v:.4f}" for k, v in d.items()))
        self._check = now

    def save_model(self, path: str):
        # every rank gathers (MADDPG's env farm), the coordinator writes; the
        # barrier keeps the others from running ahead while it writes
        ckpt.save(path, self.ts, self.mesh)
        distributed.barrier("save_model")

    def load_model(self, path: str):
        distributed.barrier("load_model_enter")
        ckpt.load(path, self.ts, self.mesh)
        distributed.barrier("load_model_exit")
        self.algo.replicate(self.ts)
