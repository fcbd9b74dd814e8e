"""Train the port's default config and record its learning curve.

The port's counterpart of ``scripts/run_dcc_curve.py``: ``MAPPO`` of
``dcc_tpu_torch`` built from the default config (200 iterations x 150 steps
x 16 envs, shared feed-forward MAPPO), seeded with SEED, and
``train_iteration`` called ``n_iters`` times. The series and the metric
definitions are those of ``run_dcc_curve.py``'s ``_dump``: reward = sum over
steps of the mean per-env team reward, coverage_rate = mean over envs of the
max coverage over the episode. With ``DCC_CURVE_ALGO_YAML`` naming MADDPG's
YAML, the algorithm is MADDPG on the same env and run shape, its series
those of ``run_dcc_curve.py``'s MADDPG arm (reward = mean over steps of the
mean team reward, ``qf_loss``, ``policy_loss``).
``tests/test_torch_curve_parity.py`` reads the files; it never runs this
script at full length.

One seed:

    python scripts/run_torch_curve.py SEED [OUT_DIR]

writes ``OUT_DIR/dcc_tpu_torch_seed{SEED}.json`` (``..._bf16_seed{SEED}``
with ``DCC_CURVE_DTYPE=bfloat16``), atomically every 10 iterations and at
the end. ``OUT_DIR`` defaults to ``learning_curves_torch/`` at the root of
the repository. Environment:

* ``DCC_CURVE_DTYPE``: the compute dtype (``bfloat16`` is the arm that runs
  K1-K4 on the card);
* ``DCC_CURVE_ALGO_YAML``: the algo YAML (default ``mappo.yaml``); the file's
  stem then names the arm, e.g.
  ``DCC_CURVE_ALGO_YAML=dcc_tpu_torch/configs/algo_config/maddpg_tuned.yaml``
  writes ``dcc_tpu_torch_maddpg_tuned_seed{SEED}.json``;
* ``DCC_CURVE_CONFIG=connect``: the connectivity force on
  (``comm_force_scale`` 5.0, ``comm_r_scale`` 0.95, as
  ``run_dcc_curve.py``'s ``connect`` variant); adds ``_connect`` to the stem;
* ``DCC_CURVE_COMPENSATED=1``: the pull force's chain in double-float
  (``compensated_forces``); adds ``_comp``;
* ``DCC_CURVE_ENV_DTYPE=float64``: the env in float64 on the device
  (``env_dtype``); adds ``_envf64``. So the three connectivity arms write
  ``dcc_tpu_torch_connect``, ``dcc_tpu_torch_connect_comp`` and
  ``dcc_tpu_torch_connect_envf64``, and no knob's files can overwrite
  another arm's;
* ``DCC_CURVE_ITERS``: fewer iterations (a short check);
* ``DCC_CURVE_DEVICE``: ``cuda`` (default) or ``cpu``.

Several seeds at once, N processes on one card, each seed a child process
of the one-seed form (the kernels are built once, before the first child):

    python scripts/run_torch_curve.py --pool N SEED [SEED ...] [--out OUT_DIR]

Each file's ``concurrent`` records N, the most seeds that shared the card
at once (1 for the one-seed form; the last seeds of a pool may share it
with fewer); ``system`` names the torch version, the card and its power
limit as ``nvidia-smi`` reports them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from dcc_tpu_torch.algos import MAPPO, make_algo  # noqa: E402
from dcc_tpu_torch.configs.loader import load as load_config  # noqa: E402
from dcc_tpu_torch.configs.loader import load_yaml_merged  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "learning_curves_torch")
FIELDS = ["value_loss", "policy_loss", "dist_entropy", "ratio"]
MADDPG_FIELDS = ["qf_loss", "policy_loss"]
# set by the pool for its children: how many seeds share the card
CONCURRENT_ENV = "DCC_CURVE_CONCURRENT"


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, else the
    device's name."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[device.index or 0] if out else torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def env_overrides() -> dict:
    """The env knobs' config overrides (``run_dcc_curve.py:68-102``)."""
    out = {}
    variant = os.environ.get("DCC_CURVE_CONFIG", "default")
    if variant == "connect":
        out.update(comm_force_scale=5.0, comm_r_scale=0.95)
    elif variant != "default":
        raise SystemExit(f"unknown DCC_CURVE_CONFIG {variant!r}")
    if os.environ.get("DCC_CURVE_COMPENSATED"):
        out["compensated_forces"] = True
    if os.environ.get("DCC_CURVE_ENV_DTYPE"):
        out["env_dtype"] = os.environ["DCC_CURVE_ENV_DTYPE"]
    return out


def stem() -> str:
    algo_yaml = os.environ.get("DCC_CURVE_ALGO_YAML")
    if algo_yaml:
        base = "dcc_tpu_torch_" + os.path.splitext(os.path.basename(algo_yaml))[0]
    elif os.environ.get("DCC_CURVE_DTYPE", "float32") in ("float32", "fp32", "f32"):
        base = "dcc_tpu_torch"
    else:
        base = "dcc_tpu_torch_bf16"
    env = env_overrides()
    f64 = env.get("env_dtype", "float32") in ("float64", "f64", "fp64")
    return (base + ("_connect" if "comm_force_scale" in env else "")
            + ("_comp" if env.get("compensated_forces") else "") + ("_envf64" if f64 else ""))


def run_seed(seed: int, out_dir: str, tag: str = "") -> None:
    """Train seed ``seed`` and write its curve to ``out_dir`` (``tag`` is
    added to the file's stem)."""
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device(os.environ.get("DCC_CURVE_DEVICE", "cuda"))
    if device.type == "cuda":
        # f32 means full f32, as the Learner sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    overrides = {"seed": seed, **env_overrides()}
    if os.environ.get("DCC_CURVE_DTYPE"):
        overrides["compute_dtype"] = os.environ["DCC_CURVE_DTYPE"]
    if os.environ.get("DCC_CURVE_ITERS"):
        overrides["n_iters"] = int(os.environ["DCC_CURVE_ITERS"])
    algo_yaml = os.environ.get("DCC_CURVE_ALGO_YAML") or None
    cfg, env_cfg, _ = load_config(overrides, algo_yaml=algo_yaml)
    n_iters = int(cfg["n_iters"])
    algo = make_algo(cfg, env_cfg, device=device)
    fields = FIELDS if isinstance(algo, MAPPO) else MADDPG_FIELDS
    ts = algo.init_state(seed)
    meta = {
        "system": f"dcc_tpu_torch (torch {torch.__version__}, {card(device)})",
        "concurrent": int(os.environ.get(CONCURRENT_ENV, "1")),
        "algo_yaml": os.path.basename(algo_yaml or "mappo.yaml"),
        "compute_dtype": getattr(algo.cfg, "compute_dtype", "float32"),
        "env_dtype": getattr(algo.cfg, "env_dtype", "float32"),
        "comm_force_scale": env_cfg.comm_force_scale,
        "comm_r_scale": env_cfg.comm_r_scale,
        "compensated_forces": env_cfg.compensated_forces,
        "seed": seed,
        "n_iters": n_iters,
        "n_rollout_threads": int(cfg["n_rollout_threads"]),
        "max_ep_len": int(cfg["max_ep_len"]),
    }
    path = os.path.join(out_dir, f"{stem()}{tag}_seed{seed}.json")
    series = {k: [] for k in ["reward", "coverage_rate"] + fields + ["iter_time_s"]}
    t_start = time.time()
    for it in range(1, n_iters + 1):
        t0 = time.time()
        m = algo.train_iteration(ts)  # returns floats: the iteration has ended
        dt = time.time() - t0
        m = m._asdict() if hasattr(m, "_asdict") else m
        for k in ["reward", "coverage_rate"] + fields:
            series[k].append(float(m[k]))
        series["iter_time_s"].append(round(dt, 4))
        if it % 10 == 0 or it == 1:
            print(f"[torch sd{seed}] iter {it}/{n_iters} reward {series['reward'][-1]:.1f} "
                  f"coverage {series['coverage_rate'][-1]:.3f} ({dt:.2f}s/iter)", flush=True)
        if it % 10 == 0 or it == n_iters:
            dump(path, meta, series, time.time() - t_start)
    print(f"[torch sd{seed}] done in {time.time() - t_start:.0f}s", flush=True)


def dump(path: str, meta: dict, series: dict, elapsed: float) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({**meta, "elapsed_s": round(elapsed, 1), "series": series}, f)
    os.replace(tmp, path)


def run_pool(n: int, jobs, out_dir: str, script: str = os.path.abspath(__file__)) -> int:
    """Run ``jobs`` as child processes of ``script`` (its one-seed form),
    ``n`` at a time; a job is a seed, or the arguments before OUT_DIR as a
    list of strings. Returns the number of children that failed (each is
    reported with its arguments)."""
    algo_file = str(load_yaml_merged(algo_yaml=os.environ.get("DCC_CURVE_ALGO_YAML") or None)
                    .get("algo_file", "mappo"))
    if os.environ.get("DCC_CURVE_DEVICE", "cuda") == "cuda" and "mappo" in algo_file:
        # MAPPO's kernels; MADDPG runs none
        from dcc_tpu_torch.ops import cuda_build

        print(f"[pool] kernels built in {cuda_build.build()['_seconds']:.1f}s", flush=True)
    env = dict(os.environ, **{CONCURRENT_ENV: str(n), "OMP_NUM_THREADS": "1"})
    todo = [[str(j)] if isinstance(j, int) else list(j) for j in jobs]
    running, failed = [], []
    t0 = time.time()
    while todo or running:
        while todo and len(running) < n:
            args = todo.pop(0)
            running.append((args, subprocess.Popen(
                [sys.executable, script, *args, out_dir], env=env)))
        time.sleep(1.0)
        for job in list(running):
            args, p = job
            if p.poll() is not None:
                running.remove(job)
                if p.returncode != 0:
                    failed.append(" ".join(args))
                    print(f"[pool] {' '.join(args)} failed (rc {p.returncode})", flush=True)
    print(f"[pool] {len(jobs)} runs, {n} at a time, in {time.time() - t0:.0f}s; "
          f"failed: {failed}", flush=True)
    return len(failed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("seeds", nargs="+", help="SEED [OUT_DIR], or the seeds with --pool")
    p.add_argument("--pool", type=int, default=0, help="run the seeds N at a time")
    p.add_argument("--out", default=DEFAULT_OUT, help="output directory of --pool")
    args = p.parse_args(argv)
    if args.pool:
        return 1 if run_pool(args.pool, [int(s) for s in args.seeds], args.out) else 0
    if len(args.seeds) > 2:
        p.error("one SEED and an optional OUT_DIR (use --pool for several seeds)")
    run_seed(int(args.seeds[0]), args.seeds[1] if len(args.seeds) > 1 else DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
