"""Diagnostic arms of the learning curves: ``scripts/run_torch_curve.py``
with one or both of the fused loss's kernels replaced by its plain PyTorch
version, run on the card's tensors (everything else as the runner: K1, K2).

    DCC_CURVE_DTYPE=bfloat16 python scripts/curve_variant.py [--plain P] SEED [OUT_DIR]
    DCC_CURVE_DTYPE=bfloat16 python scripts/curve_variant.py --pool N [--plain P ...] \
        SEED... [--out DIR]

``--plain`` names what runs plain: ``k3k4`` (default, both), ``k3`` (the
actor's K3 alone) or ``k4`` (the critic's K4 alone); with ``--pool`` it may
name several, and every seed runs under each. A run writes
``dcc_tpu_torch_bf16_plain_{P}_seed{SEED}.json`` in the runner's schema
(default directory ``learning_curves_torch/diagnostic/``, which the learning
gate does not read). The arms tell each kernel's share in a gap between the
bf16 arm and the bands from that of the bf16 path the kernels compute.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run_torch_curve as R  # noqa: E402

from dcc_tpu_torch.ops import fused_ppo as FP  # noqa: E402

PLAIN = ("k3k4", "k3", "k4")
OUT = os.path.join(R.DEFAULT_OUT, "diagnostic")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("seeds", nargs="+")
    p.add_argument("--pool", type=int, default=0)
    p.add_argument("--plain", nargs="+", choices=PLAIN, default=["k3k4"])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if args.pool:
        jobs = [[f"--plain={v}", s] for s in args.seeds for v in args.plain]
        return 1 if R.run_pool(args.pool, jobs, args.out,
                               script=os.path.abspath(__file__)) else 0
    if len(args.plain) != 1 or len(args.seeds) > 2:
        p.error("one --plain, one SEED and an optional OUT_DIR (use --pool for several)")
    plain = args.plain[0]
    # actor_ppo_grads_packed / critic_value_grads_packed pick these by name
    if "k3" in plain:
        FP.actor_grads_cuda = FP.actor_grads_plain
    if "k4" in plain:
        FP.critic_grads_cuda = FP.critic_grads_plain
    R.run_seed(int(args.seeds[0]), args.seeds[1] if len(args.seeds) > 1 else OUT,
               tag=f"_plain_{plain}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
