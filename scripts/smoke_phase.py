#!/usr/bin/env python3
"""Run one phase of ``chip_smoke.py`` against the PyTorch / CUDA port of any
checkout, on one GPU.

    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] updates [--k2-plain]
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] gae
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] k2
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] presets
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] wide
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] pois
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] hidden
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] timing
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] maddpg
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] precision
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] mesh
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] deep
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] blocked
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] train -- TAG [TAG ...]
    python3 scripts/smoke_phase.py [--root DIR] [--out FILE] profile [-- train arguments ...]
    python3 scripts/smoke_phase.py [--root DIR] --out FILE.pt bits
    python3 scripts/smoke_phase.py [--root DIR] --compare FILE.pt bits

``updates`` holds the updates of ``chip_smoke.UPDATE_CHECKS`` on the card
against the CPU (``chip_smoke.check_updates_against_cpu``); with
``--k2-plain`` it then holds the recurrent bf16 update again with K2's
forward through its bf16 plain version on the card
(``ops.fused_mlp.trunk_forward_plain``) and K2b unchanged, which tells
whether K2's summation order moves that update's reading. ``gae``
builds the kernels, prints K1's registers and spills (where this call
compiled them) and holds K1 against its plain version through
``compute_gae_cuda`` at T = 150 and 16 and 16,384 envs, timed (CUDA
events, the profiler's device us, the wrapper's host us;
``chip_smoke.check_gae``), whatever C entry it goes through.
``k2`` builds the kernels and holds K2 (the trunk forward) against its plain
version on the actor and critic rows at 16 and 16,384 envs, f32 and bf16,
timed (``chip_smoke.check_trunk_forward``). ``presets`` builds the kernels
and holds K2-K4, K2b and K3u / K4u at the one-card presets' widths, on the
data the smoke draws for them (``chip_smoke.check_presets``). ``wide``
builds the kernels and holds K2-K4, the dV0 kernel in both modes, the
chunked K2b and K4u and the layer-0 input backward at the 20-UAV preset's
widths (actor 242, critic 4,840) at 16 and 1,024 envs
(``chip_smoke.check_wide``). ``pois`` builds the kernels and holds the
chunked K2, K3 and K3u (with K4, K4u, dV0 and the layer-0 input backward)
at the many-PoI swarms' widths: 4 UAVs x 300 PoIs (actor 1,510, critic
6,040) at 16 and 1,024 envs, 4 x 360 and the 20-UAV preset with 50 PoIs
(``chip_smoke.check_many_pois``). ``hidden`` builds the kernels and holds
every kernel at ROADMAP B3's hidden widths, 100 to 1,024, and times them at
the main path's shapes at 512 (``chip_smoke.check_wide_hidden``).
``timing`` builds the kernels and times the bf16 K2, K2b, K3 / K4 and K3u
/ K4u at the default widths, hidden 256, on the model's trunk with tanh (no
relu masks asked for), against their plain versions, at 16 envs and at
16,384 (a quarter of that for the gradient kernels), as ``chip_smoke.py``
times them, then the layer-0 tail (dV0 folded and affine, cuBLAS's product
beside it, the layer-0 input backward without dx) at the wide runs' shapes
(``chip_smoke.check_tail_timing``): the same code on any checkout since
the chunked K4u, so that two builds are compared in one call (parent,
change, change, parent).
``maddpg`` holds one MADDPG update on the card against the CPU
(``chip_smoke.check_maddpg_update``), then trains the smoke's MADDPG and
``spread`` runs (``chip_smoke.SCENARIO_RUNS``) with their checks and
profiles the MADDPG runs on coverage.
``precision`` builds the kernels and runs the smoke's precision phase
(``chip_smoke.check_precision``): the df64 primitives and the compensated
pull force on the card against the CPU and the f64 truth, the six golden
traces replayed on the card in f64, the env step's device kernels with the
df64 force on and off, the three connectivity-force arms trained at 16 and
1,024 envs, and one f64-env rollout on the card against the CPU.
``mesh`` builds the kernels and runs the smoke's mesh phase
(``chip_smoke.check_mesh``): a 1-rank NCCL mesh against the unsharded run,
2 gloo ranks on card 0 for the default bf16 config and the 20-UAV preset at
1,024 envs against one process, MADDPG over 2 ranks, and 2 NCCL ranks on
two cards where the machine shows two.
``deep`` builds the kernels and runs the smoke's deep phase
(``chip_smoke.check_deep``): every kernel's row-tile plan at 8, 9 and 32
layers, every kernel of the trunk in f32 and bf16 against its plain version
at those depths (timed at 9 and 32), the chunked layouts on the 20-UAV
preset's critic rows at 9 and 32 layers, and the deep training runs
(``chip_smoke.DEEP_RUNS``) with their launch checks.
``blocked`` builds the kernels and runs the smoke's column-blocked phase
(``chip_smoke.check_blocked``): the row-tile plans at hidden 1,152, 2,048
and 4,096, the column-blocked layout bit for bit against the staged and
depth layouts at 512 and 1,024, every kernel in it against its plain
version at 1,152, 2,048 and 4,096 (16 envs) and at the main path's shapes
at 2,048 (256 envs), timed, and the runs of ``chip_smoke.BLOCKED_RUNS``.
``train`` trains the ``chip_smoke.TRAIN_RUNS`` (and ``DEEP_RUNS``, ``BLOCKED_RUNS``) whose tags are given, with
their launch checks (``chip_smoke.train_run``). ``profile`` trains with
``chip_smoke.py``'s base arguments plus the given ones (for example
``--compute-dtype bfloat16 --use-recurrent-policy true``),
then profiles one more iteration (``chip_smoke.profile_iteration``: device
time by kernel name, the device's idle share). ``bits`` runs every bf16
kernel at the widths the kernels took before their hidden layers ran in
column passes (``chip_smoke.kernel_bits``) and saves the outputs, launch
counts and row tiles to ``--out``, or with ``--compare`` holds them bit for
bit against a record saved before (exit 1 where any differs): run it with
``--root`` on a ``git archive`` of another commit, then here with
``--compare``. ``--root`` names the checkout
whose ``dcc_tpu_torch`` runs (default: this one), so that another commit's
package, unpacked with ``git archive``, is measured by the same code.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=HERE, help="checkout whose dcc_tpu_torch runs")
    ap.add_argument("--out", default=None, help="also write the results to this JSON file")
    ap.add_argument("--k2-plain", action="store_true",
                    help="updates: also the recurrent bf16 update with K2's plain forward")
    ap.add_argument("--compare", default=None,
                    help="bits: hold the outputs against this record of another checkout")
    ap.add_argument("phase", choices=("updates", "gae", "k2", "presets", "wide", "pois",
                                       "hidden", "timing", "maddpg", "precision", "mesh",
                                       "deep", "blocked", "train", "profile", "bits"))
    ap.add_argument("train_args", nargs="*",
                    help="arguments for dcc_tpu_torch.train (profile); run tags (train)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase: no CUDA device", file=sys.stderr)
        return 2
    out = os.path.abspath(args.out) if args.out else None
    against = os.path.abspath(args.compare) if args.compare else None
    sys.path.insert(0, HERE)
    import chip_smoke

    sys.path.insert(0, os.path.abspath(args.root))
    os.chdir(args.root)
    import dcc_tpu_torch

    print(f"card: {chip_smoke.card_line()}; package {os.path.dirname(dcc_tpu_torch.__file__)}",
          flush=True)
    if args.phase == "bits":
        record = chip_smoke.kernel_bits()
        if against:
            faults = chip_smoke.compare_bits(record, torch.load(against))
            for f in faults:
                print(f"  {f}", flush=True)
            print(f"bits: {len(record)} calls, {sum(len(r['tensors']) for r in record.values())} "
                  f"outputs against {against}: "
                  f"{'bit-identical' if not faults else f'{len(faults)} differences'}",
                  flush=True)
            return 1 if faults else 0
        if not out:
            print("smoke_phase: bits needs --out or --compare", file=sys.stderr)
            return 2
        os.makedirs(os.path.dirname(out), exist_ok=True)
        torch.save(record, out)
        print(f"bits: {len(record)} calls saved to {out}", flush=True)
        return 0
    if args.phase == "train":
        results = {}
        try:
            for tag, extra, per_iter in (*chip_smoke.TRAIN_RUNS,
                                         *getattr(chip_smoke, "DEEP_RUNS", ()),
                                         *getattr(chip_smoke, "BLOCKED_RUNS", ())):
                if tag in args.train_args:
                    chip_smoke.train_run(results, tag, chip_smoke.BASE_ARGS + extra, per_iter)
        except chip_smoke.SmokeFailure as e:
            print(f"smoke_phase: FAILED: {e}", file=sys.stderr)
            return 1
    elif args.phase in ("precision", "mesh", "deep", "blocked"):
        from dcc_tpu_torch.ops import cuda_build

        built = cuda_build.build(verbose=True)
        print(f"built in {built['_seconds']:.1f} s", flush=True)
        results = {}
        try:
            if args.phase == "blocked":
                results["checks"], results["runs"] = [], {}
                results["ptxas"] = chip_smoke.ptxas_report(built.get("_ptxas", {}), False)
                chip_smoke.check_blocked(results["checks"], results["ptxas"])
                chip_smoke.train_runs(results["runs"], chip_smoke.BLOCKED_RUNS)
            elif args.phase == "deep":
                results["checks"], results["runs"] = [], {}
                chip_smoke.check_deep(results["checks"])
                chip_smoke.train_runs(results["runs"], chip_smoke.DEEP_RUNS)
            else:
                (chip_smoke.check_precision if args.phase == "precision"
                 else chip_smoke.check_mesh)(results)
        except chip_smoke.SmokeFailure as e:
            print(f"smoke_phase: FAILED: {e}", file=sys.stderr)
            return 1
    elif args.phase == "maddpg":
        results = {}
        try:
            chip_smoke.check_maddpg_update(results)
            for tag, extra, per_iter in chip_smoke.TRAIN_RUNS:
                if tag in chip_smoke.SCENARIO_RUNS:
                    learner = chip_smoke.train_run(results, tag, chip_smoke.BASE_ARGS + extra,
                                                   per_iter)
                    if tag in chip_smoke.PROFILED:
                        results[f"profile {tag}"] = chip_smoke.profile_iteration(learner, tag)
        except chip_smoke.SmokeFailure as e:
            print(f"smoke_phase: FAILED: {e}", file=sys.stderr)
            return 1
    elif args.phase in ("updates", "gae", "k2", "presets", "wide", "pois", "hidden", "timing"):
        results: dict = {}
        try:
            if args.phase == "updates":
                chip_smoke.check_updates_against_cpu(results)
                if args.k2_plain:
                    chip_smoke.check_k2_plain_update(results)
            else:
                from dcc_tpu_torch.ops import cuda_build

                built = cuda_build.build(verbose=True)
                results["ptxas"] = chip_smoke.ptxas_report(built.get("_ptxas", {}), False)
                results[args.phase] = []
                if args.phase == "gae":
                    chip_smoke.check_gae(results["gae"], chip_smoke.GAE_TIMED, entry=None)
                elif args.phase == "presets":
                    chip_smoke.check_presets(results["presets"])
                elif args.phase == "wide":
                    chip_smoke.check_wide(results["wide"])
                elif args.phase == "pois":
                    chip_smoke.check_many_pois(results["pois"], results["ptxas"])
                elif args.phase == "hidden":
                    chip_smoke.check_wide_hidden(results["hidden"], results["ptxas"])
                elif args.phase == "timing":
                    chip_smoke.check_default_timing(results["timing"])
                else:
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    chip_smoke.check_trunk_forward(results["k2"], gen)
        except chip_smoke.SmokeFailure as e:
            print(f"smoke_phase: FAILED: {e}", file=sys.stderr)
            return 1
    else:
        from dcc_tpu_torch import train

        learner = train.main(chip_smoke.BASE_ARGS + args.train_args)
        results = chip_smoke.profile_iteration(learner, " ".join(args.train_args) or "default")
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
