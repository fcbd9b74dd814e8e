"""Train the 20-UAV preset (``dcc_20uav_16k_dist``) through the CLI on one
card and record its iteration time, the phase table and the peak device
memory.

    python scripts/wide_run.py [--envs 16384] [--iters 2] [--out FILE] [-- train arguments ...]

The preset as written (20 UAVs, 40 PoIs, bf16, 15 epochs, its 16,384 envs
unless ``--envs`` says otherwise; further CLI arguments after ``--``, for
example ``--fused-loss off``) through ``dcc_tpu_torch.train.main``; the
kernels are built before the run, so no iteration includes the build.
Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
run's wall time, the Learner's phase table (count, total, mean and max of
``train`` -- one iteration -- and of ``rollout``, ``returns``, ``update``,
each timed to the device's end), the kernels' launches,
``torch.cuda.max_memory_allocated`` over the run and the last metrics;
``--out`` also writes it to a file.
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

YAML = os.path.join("dcc_tpu_torch", "configs", "env_config", "dcc_20uav_16k_dist.yaml")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--envs", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("train_args", nargs="*", help="further arguments for dcc_tpu_torch.train")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_run: no CUDA device", file=sys.stderr)
        return 2
    from dcc_tpu_torch import train
    from dcc_tpu_torch.ops import LAUNCHES, cuda_build, reset_launches

    os.chdir(REPO)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernels built in {cuda_build.build()['_seconds']:.1f} s", flush=True)
    cli = ["--env-yaml", YAML, "--n-rollout-threads", str(args.envs), "--n-iters",
           str(args.iters), "--save-gifs", "false", "--save-model", "false", "--seed", "0",
           *args.train_args]
    print(f"python -m dcc_tpu_torch.train {' '.join(cli)}", flush=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    learner = train.main(cli)
    torch.cuda.synchronize()
    res = dict(card=card, envs=args.envs, iters=args.iters, train_args=args.train_args,
               wall_s=time.perf_counter() - t0, phases=learner.timer.summary(),
               launches=dict(LAUNCHES),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               metrics=learner.last_metrics._asdict())
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
