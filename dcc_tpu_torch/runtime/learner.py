"""Learner: the train / eval / save / log cadence around :class:`MAPPO`.

Counterpart of :class:`dcc_tpu.runtime.learner.Learner`. Run artifacts go to
``<main_save_path>/<save_name>/<MMDD_HHMM_sd{seed}>/`` with a ``config.json``
snapshot. Rendering (ROADMAP A14), device meshes (ROADMAP A13), algorithms
other than MAPPO (ROADMAP A10) and device-trace capture are not ported yet:
a config that asks for them raises at construction instead of skipping
them.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..algos.mappo import MAPPO
from ..configs.loader import load as load_config
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
        if use_mesh:
            raise NotImplementedError("--mesh is not ported yet (ROADMAP A13: multi-GPU)")
        algo_file = str(cfg.get("algo_file", "mappo"))
        if "mappo" not in algo_file:
            raise NotImplementedError(
                f"algo_file {algo_file!r} is not ported yet (ROADMAP A10: MADDPG)"
            )
        renders = bool(cfg.get("save_gifs", True)) or bool(cfg.get("render_live", False))
        if (renders and self.is_save_model
                and int(cfg.get("render_interval", 200)) <= self.n_iters):
            raise NotImplementedError(
                "rendering is not ported yet (ROADMAP A14: render); set "
                "save_gifs=false (and render_live=false) or a render_interval "
                "above n_iters"
            )
        if cfg.get("profile_dir"):
            raise NotImplementedError(
                "device-trace capture (profile_dir) is not ported yet (ROADMAP: "
                "torch.profiler trace window)"
            )

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 means full f32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.algo = MAPPO(self.algo_cfg, self.env_cfg, device=self.device)
        self.ts = self.algo.init_state(self.seed)
        self.n_eval = int(cfg.get("n_eval_rollout_threads", 16))

        self.output_path = None
        if self.is_save_model:
            name = datetime.datetime.now().strftime("%m%d_%H%M_") + f"sd{self.seed}"
            self.output_path = os.path.join(
                str(cfg.get("main_save_path", "results/")),
                str(cfg.get("save_name", "uav_dcc")),
                name,
            )
            os.makedirs(self.output_path, exist_ok=True)
            with open(os.path.join(self.output_path, "config.json"), "w") as f:
                json.dump(cfg, f, indent=4, default=str)

        if cfg.get("load_model") and cfg.get("load_model_path"):
            self.load_model(str(cfg["load_model_path"]))
            print("!!!!!Note: Load model, done!!!!!")

        self.timer = PhaseTimer()
        self._wandb = None
        if bool(cfg.get("log_wandb", False)):
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
        for it in range(1, self.n_iters + 1):
            with self.timer.phase("train"):
                m = self.algo.train_iteration(self.ts, timer=self.timer)
            self.last_metrics = m
            logs: Dict[str, Dict[str, float]] = {}
            if it % log_interval == 0:
                md = m._asdict()
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
            if logs:
                self.log(it, logs)
            if self.is_save_model and it % save_interval == 0:
                with self.timer.phase("save"):
                    path = os.path.join(self.output_path, f"models_{it}.pt")
                    self.save_model(path)
                print(f"model saved in {path}")
        print("phase timing:", json.dumps(self.timer.summary()))
        if self._wandb is not None:
            self._wandb.finish()

    def log(self, it: int, logs: Dict[str, Dict[str, float]]):
        if self._wandb is not None:
            for d in logs.values():
                self._wandb.log(d, step=it)
        now = time.time()
        print(
            f"******** iter: {it}, iter_time: {now - self._check:.2f}s, "
            f"total_time: {now - self._start:.2f}s"
        )
        for key, d in logs.items():
            print(key + "".join(f", {k}: {v:.4f}" for k, v in d.items()))
        self._check = now

    def save_model(self, path: str):
        ckpt.save(path, self.ts)

    def load_model(self, path: str):
        ckpt.load(path, self.ts)
