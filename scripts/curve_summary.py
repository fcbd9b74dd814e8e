"""Summarise the port's learning curves against the bands they are gated on.

    python scripts/curve_summary.py [PORT_DIR]

For each arm of ``learning_curves_torch/`` (or PORT_DIR), as
``tests/test_torch_curve_parity.py`` reads it: the final-20 coverage's
seed count, mean, population std, min and max, the median of each seed's
per-iteration wall time (first iteration excluded) and its ``concurrent``;
then against each band of ``benchmarks/learning_curves/`` the one-sided
Mann-Whitney p and the mean gap. A directory of single curves (e.g. one
seed run alone) is summarised the same way. The diagnostic arms of
PORT_DIR/diagnostic/ (``scripts/curve_variant.py``: the bf16 arm with K3
and K4, K3 alone or K4 alone plain) are summarised too, each with a paired
Wilcoxon test against the bf16 arm on the same seeds.
"""

import glob
import json
import os
import sys

import numpy as np
from scipy.stats import mannwhitneyu, wilcoxon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_DIR = os.path.join(ROOT, "benchmarks", "learning_curves")
ARMS = (("f32", "dcc_tpu_torch", ("reference", "dcc_tpu")),
        ("bf16", "dcc_tpu_torch_bf16", ("reference", "dcc_tpu_bf16")))
VARIANTS = tuple((f"bf16, {what} plain", f"dcc_tpu_torch_bf16_plain_{tag}",
                  ("reference", "dcc_tpu_bf16"))
                 for what, tag in (("K3 / K4", "k3k4"), ("K3", "k3"), ("K4", "k4")))


def runs(directory, system, min_iters=200):
    out = []
    for p in glob.glob(os.path.join(directory, f"{system}_seed*.json")):
        d = json.load(open(p))
        if len(d["series"]["coverage_rate"]) >= min_iters:
            out.append(d)
    return sorted(out, key=lambda d: d["seed"])


def final(ds):
    return np.array([np.mean(d["series"]["coverage_rate"][-20:]) for d in ds])


def main(port_dir=os.path.join(ROOT, "learning_curves_torch")):
    for arm, system, bands in ARMS:
        summarise(port_dir, arm, system, bands)
    variant_dir = os.path.join(port_dir, "diagnostic")
    k = {d["seed"]: final([d])[0] for d in runs(port_dir, ARMS[1][1])}
    for variant in VARIANTS:
        if summarise(variant_dir, *variant):
            v = {d["seed"]: final([d])[0] for d in runs(variant_dir, variant[1])}
            seeds = sorted(set(k) & set(v))
            diff = np.array([v[i] - k[i] for i in seeds])
            print(f"  minus the bf16 arm on {len(seeds)} paired seeds: mean {diff.mean():+.4f}, "
                  f"Wilcoxon p {float(wilcoxon(diff).pvalue):.4f}")


def summarise(port_dir, arm, system, bands) -> bool:
    """Print one arm's summary; False where the directory holds none of it."""
    ds = runs(port_dir, system)
    if not ds:
        return False
    a = final(ds)
    iters = [float(np.median(d["series"]["iter_time_s"][1:])) for d in ds]
    print(f"{arm}: {len(a)} seeds, final-20 coverage {a.mean():.4f} ± {a.std():.4f} "
          f"(min {a.min():.4f}, max {a.max():.4f}); median s/iteration {np.median(iters):.4f} "
          f"(seeds {min(iters):.4f}-{max(iters):.4f}), concurrent "
          f"{sorted({d.get('concurrent') for d in ds})}; {ds[0]['system']}")
    for band in bands:
        b = final(runs(BAND_DIR, band))
        p = float(mannwhitneyu(a, b, alternative="less").pvalue)
        print(f"  vs {band} ({len(b)} seeds, {b.mean():.4f} ± {b.std():.4f}): one-sided "
              f"Mann-Whitney p {p:.4f}, mean gap {a.mean() - b.mean():+.4f}")
    return True


if __name__ == "__main__":
    main(*sys.argv[1:])
