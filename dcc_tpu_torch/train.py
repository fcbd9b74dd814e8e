"""CLI entry: train MAPPO on the coverage env with the PyTorch port.

Any config key from the YAML files can be overridden on the command line,
as with the JAX package's ``train.py``; ``--device`` picks the device
(CUDA by default; the run raises without a GPU unless ``--device cpu``):

    python -m dcc_tpu_torch.train                       # default 4x20, 200 iters
    python -m dcc_tpu_torch.train --seed 1 --n-iters 50 --save-gifs false
    python -m dcc_tpu_torch.train --compute-dtype bfloat16 --save-gifs false
    python -m dcc_tpu_torch.train --device cpu --n-iters 2 --n-rollout-threads 4 \\
        --save-gifs false
    python -m dcc_tpu_torch.train --mesh                # the envs over every local GPU
    torchrun --nproc-per-node 8 -m dcc_tpu_torch.train --mesh   # or one rank a process

``--mesh`` with more than one visible GPU and no ``WORLD_SIZE`` spawns one
rank per GPU; under torchrun's variables each process joins the group; on
one device it runs as one process.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_overrides(argv):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mesh", action="store_true", help="shard envs over a device mesh")
    parser.add_argument("--env-yaml", default=None)
    parser.add_argument("--algo-yaml", default=None)
    parser.add_argument("--expt-yaml", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, unknown = parser.parse_known_args(argv)

    overrides = {}
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument: {tok}")
        key = tok[2:].replace("-", "_")
        if i + 1 >= len(unknown) or unknown[i + 1].startswith("--"):
            overrides[key] = True
            i += 1
        else:
            val = unknown[i + 1]
            for cast in (int, float):
                try:
                    val = cast(val)
                    break
                except ValueError:
                    continue
            if val in ("true", "True"):
                val = True
            elif val in ("false", "False"):
                val = False
            overrides[key] = val
            i += 2
    return args, overrides


def _rank_main(argv) -> None:
    """One spawned rank of ``--mesh``: train, then leave the group."""
    from dcc_tpu_torch.parallel import distributed

    main(argv)
    distributed.shutdown()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args, overrides = parse_overrides(argv)
    import torch

    from dcc_tpu_torch.parallel import distributed
    from dcc_tpu_torch.runtime.learner import Learner

    if (args.mesh and "WORLD_SIZE" not in os.environ and args.device in (None, "cuda")
            and torch.cuda.device_count() > 1):
        # one command uses every local GPU: a rank each
        distributed.spawn(_rank_main, torch.cuda.device_count(), (argv,))
        return None

    learner = Learner(
        overrides,
        use_mesh=args.mesh,
        env_yaml=args.env_yaml,
        algo_yaml=args.algo_yaml,
        expt_yaml=args.expt_yaml,
        device=args.device,
    )
    learner.train()
    return learner


if __name__ == "__main__":
    main()
    from dcc_tpu_torch.parallel import distributed

    distributed.shutdown()
