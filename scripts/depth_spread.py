#!/usr/bin/env python3
"""How far a deep trunk carries one rounding difference, on one GPU: the
readings behind ROADMAP C8.

    python3 scripts/depth_spread.py [--out FILE]

For each trunk depth of ``LAYERS`` and two trunks, the model's (1-D
parameters moved 0.1 off their init values, as ``chip_smoke.perturb_``
does) and the conditioned one (``chip_smoke.condition_deep_``: the Dense
and LN biases drawn from N(0, 1)), every bf16 kernel of the trunk (K2, K2b,
K3, K4, K3u, K4u) at the smoke's 16-env shapes, three readings of the
largest ||a - b|| / ||b|| over its output tensors:

- ``kernel``: the kernel against its plain version (the plain version on
  the kernel's relu masks);
- ``order``: the plain version against itself with every f32 product
  accumulated in f64 instead (the same roundings, another summation
  order): how far the chain carries a summation-order difference, the
  kernel aside;
- ``f32``: the kernel computed in f32 against the bf16 plain version.

Then ``chip_smoke.check_deep_bits``: each bf16 gradient kernel in its
depth layout against its staged layout, bit for bit (exit 1 where they
differ).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (8, 9, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="also write the readings to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("depth_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import chip_smoke as cs

    print(f"card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {"card": cs.card_line(), "spread": [], "bits": []}
    for L in LAYERS:
        for conditioned in (False, True):
            trunk = "conditioned" if conditioned else "model"
            for name, kern, plain, rows in cs.deep_kernel_cases(gen, L, 256, conditioned):
                masks = torch.zeros((L, rows, 256), dtype=torch.uint8, device="cuda")
                k = kern(True, relu_masks=masks)
                p = plain(masks=masks)
                with cs.f64_products():
                    p64 = plain(masks=masks)
                k32 = kern(False)
                row = dict(layers=L, trunk=trunk, kernel=name, kernel_rel=cs.max_rel(k, p),
                           order_rel=cs.max_rel(p64, p), f32_rel=cs.max_rel(k32, p))
                out["spread"].append(row)
                print(f"  L={L:2d} {trunk:11s} {name:26s} kernel {row['kernel_rel']:.3e}  "
                      f"order {row['order_rel']:.3e}  f32 {row['f32_rel']:.3e}", flush=True)
                del k, p, p64, k32, masks
                torch.cuda.empty_cache()
    try:
        cs.check_deep_bits(out["bits"])
    except cs.SmokeFailure as e:
        print(f"depth_spread: FAILED: {e}", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
