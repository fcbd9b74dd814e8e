#!/usr/bin/env python3
"""Time K1 (``csrc/gae.cu``) at other (W, S, L) plans than ``gae_plan``'s,
on one GPU.

    python3 scripts/gae_plans.py [--T 150] [--envs 16 16384]

For each column count, every plan of W columns (32 and 16) times S segments
of L = ceil(T / S) steps (at most 32; rounds beyond) that the kernel's
thread limit allows: the C entry ``dcc_gae_seg`` called directly, held
against ``ops.gae.compute_gae`` (max abs error within chip_smoke.py's K1
bound, 1e-5 * (max|A| + 1); the script exits 1 after the last plan if any
plan misses it), timed with CUDA events over
200 back-to-back launches (best of 3 runs) and by the profiler's device time
per launch (``chip_smoke.device_us``). The plan ``gae_plan`` picks is marked
with ``*``.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--T", type=int, default=150)
    ap.add_argument("--envs", type=int, nargs="+", default=[16, 16384])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gae_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops.cuda_gae import gae_plan, max_block_threads
    from dcc_tpu_torch.ops.gae import compute_gae

    print(f"card: {chip_smoke.card_line()}", flush=True)
    lib = cb.library("gae")
    T = args.T
    failed = []
    for B in args.envs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        r = torch.randn(T, B, device="cuda", generator=gen)
        v = torch.randn(T + 1, B, device="cuda", generator=gen)
        m = (torch.rand(T + 1, B, device="cuda", generator=gen) > 0.05).float()
        pa, pr = compute_gae(r, v, m, 0.99, 0.95)
        tol = 1e-5 * (float(pa.abs().max()) + 1.0)
        adv, ret = torch.empty_like(r), torch.empty_like(r)
        stream = cb.stream_of(r)
        chosen = gae_plan(T, B)
        for W in sorted({min(B, 32), min(B, 16)}, reverse=True):
            for S in range(1, 51):
                L = min(32, -(-T // S))
                if W * S > max_block_threads(L) or (S > 1 and L == min(32, -(-T // (S - 1)))
                                                    and L < 32):
                    continue  # over the thread limit, or the same L as S - 1 with more threads

                def call():
                    code = lib.dcc_gae_seg(r.data_ptr(), v.data_ptr(), m.data_ptr(),
                                           adv.data_ptr(), ret.data_ptr(), T, B, W, S, L, 0.99,
                                           0.99 * 0.95, stream)
                    cb.check("gae", code, "gae")

                call()
                torch.cuda.synchronize()
                err = max(float((adv - pa).abs().max()), float((ret - pr).abs().max()))
                if not err <= tol:
                    failed.append((B, W, S, L, err))
                event = min(chip_smoke.time_ms(call, 200)[0] for _ in range(3)) * 1e3
                dev = chip_smoke.device_us(call, 200, "gae")
                mark = "*" if (W, S, L) == chosen[:3] else " "
                print(f"{mark} T={T} B={B} W={W} S={S} L={L} blocks={-(-B // W)} "
                      f"max_abs={err:.2e} event us={event:.2f} device us="
                      f"{dev['kernel'] if dev else float('nan'):.2f}", flush=True)
    if failed:
        print(f"gae_plans: FAILED: (B, W, S, L, max_abs) over the bound: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
