#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``dcc_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--ptxas] [--out results.json]

Phases (any failure exits non-zero):

1. print the card (``nvidia-smi`` name and power limit, torch / CUDA);
2. build the CUDA kernels from ``dcc_tpu_torch/csrc`` and print the time;
3. hold each kernel K1-K4 against its plain PyTorch version on the card, in
   f32 and bf16 where it has both modes, at the default shapes (16 envs)
   and at bench.py's headline 16384 envs (a quarter of that for K3 / K4,
   whose plain versions materialize (rows, 256) f32 tensors), and time both
   with CUDA events (median of k runs). Biases and LN affines are moved
   off their init values so that every bf16 bias add rounds. Each bf16
   check also runs the kernel in f32 on the same inputs and requires that
   reading to lie outside the bf16 bound, so the bound tells the bf16
   rounding points from none at all;
4. hold one fused f32 PPO update on the card against the same update on the
   CPU (plain versions) from identical parameters and trajectory;
5. train 2 iterations of the default f32 config and 2 of the bf16 config
   through ``dcc_tpu_torch.train.main``, print the metrics and phase times,
   and require every kernel of the bf16 path to have launched;
6. print the ``{"kernels": [...]}`` line, the card line, and the result.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_FP32 = 67e12  # FP32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12  # bf16 tensor cores, dense, FLOP/s
BIG_ENVS = 16384  # bench.py's headline env count
# bf16 bounds on ||kernel - plain|| / ||plain|| per tensor. Kernel and plain
# version round at the same points; summation order flips single bf16
# roundings. The bound sits between those readings and the kernel computed
# in f32 on the same inputs, which every bf16 check also measures.
K2_BF16_REL = 2e-3
PPO_BF16_REL = 4e-3
REPLACES = {
    "gae": "dcc_tpu/ops/pallas_gae.py:56",
    "fused_mlp": "dcc_tpu/ops/fused_mlp.py:319",
    "actor_ppo_grads": "dcc_tpu/ops/fused_ppo.py:575",
    "critic_ppo_grads": "dcc_tpu/ops/fused_ppo.py:667",
}
SOURCES = {
    "gae": "dcc_tpu_torch/csrc/gae.cu",
    "fused_mlp": "dcc_tpu_torch/csrc/fused_mlp.cu",
    "actor_ppo_grads": "dcc_tpu_torch/csrc/fused_ppo.cu",
    "critic_ppo_grads": "dcc_tpu_torch/csrc/fused_ppo.cu",
}


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare(name, got, want, max_rel, max_abs=None):
    """Per-tensor max |k - p| and ||k - p|| / ||p||; raises past the bounds.
    Returns the worst of each and the index of the tensor with the worst rel."""
    worst_abs, worst_rel, worst_i = 0.0, 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not bool(g.isfinite().all()):
            raise SmokeFailure(f"{name}[{i}]: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                               f"or non-finite output")
        diff = (g - w).abs()
        a = float(diff.max()) if diff.numel() else 0.0
        r = float(diff.norm() / w.norm().clamp_min(1e-30)) if diff.numel() else 0.0
        worst_abs = max(worst_abs, a)
        if r > worst_rel:
            worst_rel, worst_i = r, i
        if r > max_rel or (max_abs is not None and a > max_abs):
            raise SmokeFailure(f"{name}[{i}]: max_abs {a:.3e} rel {r:.3e} exceeds "
                               f"rel {max_rel} / abs {max_abs}")
    return worst_abs, worst_rel, worst_i


def perturb_(net, gen) -> None:
    """Move every 1-D parameter (biases, LN affines, log_std) off its init
    value (zero biases, unit scales), in place."""
    import torch

    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device=p.device))


def f32_reading(name, got, want, bf16_tol):
    """How far the kernel computed in f32 lies from the bf16 plain version;
    raises unless that is outside the bf16 bound."""
    worst = max(float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
                for g, w in zip(got, want))
    if worst <= bf16_tol:
        raise SmokeFailure(f"{name}: the f32 kernel is within the bf16 bound "
                           f"({worst:.3e} <= {bf16_tol}); the bound is too loose")
    return worst


def bound(bytes_moved: float, ops: float, peak_ops: float):
    tb, to = bytes_moved / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(results: list):
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.envs import EnvConfig
    from dcc_tpu_torch.ops import cuda_gae, fused_mlp as FM, fused_ppo as FP
    from dcc_tpu_torch.ops.gae import compute_gae

    dev = torch.device("cuda")
    env = EnvConfig()
    T, A, D = 150, env.n_agents, env.obs_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    flat = lambda o: [*o[0], *o[1:]]  # K3 / K4 outputs as one list of tensors
    n_bytes = lambda o: 4 * sum(t.numel() for t in flat(o))  # f32 gradients

    def record(kernel, mode, envs, shape, errs, ms, plain_ms, bound_ms, bound_by,
               f32_rel=None):
        err, rel, worst = errs
        row = dict(kernel=kernel, mode=mode, envs=envs, shape=shape, max_abs_err=err,
                   rel_err=rel, worst_tensor=worst, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, f32_kernel_rel_err=f32_rel)
        results.append(row)
        extra = "" if f32_rel is None else f" (f32 kernel: rel={f32_rel:.3e})"
        print(f"  {kernel:17s} {mode:4s} envs={envs:<6d} {shape:28s} max_abs={err:.3e} "
              f"rel={rel:.3e} [{worst}]{extra} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={bound_ms:.4f} ms ({bound_by})", flush=True)

    # K1: GAE over (T, E) per-env columns
    for envs in (16, BIG_ENVS):
        r, v = randn(T, envs), randn(T + 1, envs)
        m = (torch.rand((T + 1, envs), generator=gen, device=dev) > 0.02).float()
        cols = (r.contiguous(), v[1:].contiguous(), v[:-1].contiguous(), m[1:].contiguous())
        kern = lambda: cuda_gae.gae_columns_cuda(*cols, 0.99, 0.95)
        plain = lambda: compute_gae(r, v, m, 0.99, 0.95)
        ka, kr = kern()
        pa, pr = plain()
        scale = float(pa.abs().max()) + 1.0
        # f32 with FMA contraction vs separate rounding: a few ulps of the
        # running sum; bound 1e-5 of its magnitude
        errs = compare("gae", [ka, kr], [pa, pr], 1e-5, 1e-5 * scale)
        n = T * envs
        b, by = bound(6 * 4 * n, 8 * n, PEAK_FP32)
        record("gae", "f32", envs, f"T={T} B={envs}", errs, time_ms(kern, 20),
               time_ms(plain, 5), b, by)

    # K2: trunk forward on the actor (E*A, 110) and critic (E, 440) rows
    for bf16 in (False, True):
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 fused_loss="on", fused_trunk="on"), env, device=dev)
        actor, critic = algo.make_networks(seed=1)
        perturb_(actor, gen)
        perturb_(critic, gen)
        for envs in (16, BIG_ENVS):
            for net, rows, width in ((actor, envs * A, D), (critic, envs, A * D)):
                x = randn(rows, width)
                params = [p.detach() for p in net.base.flat_params()]
                kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16)
                kern = lambda: FM.trunk_forward_cuda(x, params, **kw)
                plain = lambda: FM.trunk_forward_plain(x, params, **kw)
                # f32: summation order only; bf16: 1-ulp flips of bf16
                # roundings inside the chain (LN outputs reach |16|, ulp 1/8)
                tol = (K2_BF16_REL, 0.25) if bf16 else (1e-4, 1e-3)
                want = plain()
                errs = compare("fused_mlp", [kern()], [want], *tol)
                f32_rel = None
                if bf16:
                    f32_out = FM.trunk_forward_cuda(x, params, **{**kw, "bf16": False})
                    f32_rel = f32_reading("fused_mlp", [f32_out], [want], tol[0])
                H = 256
                ops = 2 * rows * (width * H + H * H)
                nbytes = (rows * width * 4 + rows * H * (2 if bf16 else 4)
                          + 4 * sum(p.numel() for p in params))
                b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
                record("fused_mlp", "bf16" if bf16 else "f32", envs,
                       f"rows={rows} d_in={width}", errs, time_ms(kern, 10),
                       time_ms(plain, 5), b, by, f32_rel)

    # K3 / K4: PPO loss + gradients on the T*E*A actor / T*E critic rows
    ppo_envs = BIG_ENVS // 4
    print(f"  K3 / K4 at {ppo_envs} envs (a quarter of {BIG_ENVS}): their plain versions "
          f"keep about ten (rows, 256) f32 tensors alive, which must fit in device memory",
          flush=True)
    for bf16 in (False, True):
        algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16" if bf16 else "float32",
                                 fused_loss="on", fused_trunk="on"), env, device=dev)
        actor, critic = algo.make_networks(seed=2)
        perturb_(actor, gen)
        perturb_(critic, gen)
        xdt = torch.bfloat16 if bf16 else torch.float32
        for envs in (16, ppo_envs):
            R, Rv = T * envs * A, T * envs
            obs = randn(R, D).to(xdt)
            act = randn(R, 2) * 0.5
            old_lp = -2.0 + 0.3 * randn(R, 1)
            adv = randn(R, 1)
            aux_a = FP.pack_actor_aux(act, old_lp, adv)
            kp, whf, bhf = FP.fold_trunk(
                [p.detach() for p in actor.base.flat_params()],
                actor.act_out.weight.detach().t(), actor.act_out.bias.detach(), 2, True)
            ls = actor.log_std.detach()
            kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16, clip_param=0.2)
            kern = lambda: FP.actor_grads_cuda(obs, aux_a, kp, whf, bhf, ls, **kw)
            plain = lambda: FP.actor_grads_plain(obs, aux_a, kp, whf, bhf, ls, **kw)
            k, p = kern(), plain()
            # f32: summation order of the R-row sums, and the odd row within
            # rounding of a loss kink (clip bound, min / max tie) that takes
            # the other branch; bf16: 1-ulp flips of the
            # bf16 roundings in the forward and of the rounded cotangents
            tol = PPO_BF16_REL if bf16 else 1e-3
            errs = compare("actor_ppo_grads", flat(k), flat(p), tol)
            f32_rel = None
            if bf16:
                f32_k = FP.actor_grads_cuda(obs, aux_a, kp, whf, bhf, ls,
                                            **{**kw, "bf16": False})
                f32_rel = f32_reading("actor_ppo_grads", flat(f32_k), flat(p), tol)
                del f32_k
            H = 256
            ops = 2 * R * (2 * D * H + 3 * H * H)
            # rows and aux in, folded params in, their gradients out
            nbytes = R * D * (2 if bf16 else 4) + aux_a.numel() * 4 + 2 * n_bytes(k)
            b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
            record("actor_ppo_grads", "bf16" if bf16 else "f32", envs,
                   f"rows={R} d_in={D}", errs, time_ms(kern, 5), time_ms(plain, 3),
                   b, by, f32_rel)
            del k, p

            cent = obs.reshape(Rv, A * D)
            with torch.no_grad():
                v0 = critic(cent[: min(Rv, 65536)].float())
            vpred = randn(Rv, 1) * float(v0.std() + 0.1)
            ret = vpred + 3.0 * randn(Rv, 1)
            aux_c = FP.pack_critic_aux(vpred, ret)
            norm = torch.tensor([0.5, 2.0], device=dev)
            kpc, wvf, bvf = FP.fold_trunk(
                [p.detach() for p in critic.base.flat_params()],
                critic.v_out.weight.detach().t(), critic.v_out.bias.detach(), 2, True)
            ckw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16, clip_param=0.2,
                       huber_delta=10.0, use_huber=True, use_clipped=True)
            kern = lambda: FP.critic_grads_cuda(cent, aux_c, norm, kpc, wvf, bvf, **ckw)
            plain = lambda: FP.critic_grads_plain(cent, aux_c, norm, kpc, wvf, bvf, **ckw)
            k, p = kern(), plain()
            errs = compare("critic_ppo_grads", flat(k), flat(p), tol)
            f32_rel = None
            if bf16:
                f32_k = FP.critic_grads_cuda(cent, aux_c, norm, kpc, wvf, bvf,
                                             **{**ckw, "bf16": False})
                f32_rel = f32_reading("critic_ppo_grads", flat(f32_k), flat(p), tol)
                del f32_k
            ops = 2 * Rv * (2 * A * D * H + 3 * H * H)
            nbytes = Rv * A * D * (2 if bf16 else 4) + aux_c.numel() * 4 + 2 * n_bytes(k)
            b, by = bound(nbytes, ops, PEAK_BF16 if bf16 else PEAK_FP32)
            record("critic_ppo_grads", "bf16" if bf16 else "f32", envs,
                   f"rows={Rv} d_in={A * D}", errs, time_ms(kern, 5),
                   time_ms(plain, 3), b, by, f32_rel)
            del k, p, obs, cent
            torch.cuda.empty_cache()


def check_update_against_cpu():
    """One fused f32 update on the card vs the plain versions on the CPU."""
    import torch

    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.envs import EnvConfig

    cfg = MAPPOConfig(n_rollout_threads=4, episode_length=8, ppo_epoch=2, n_iters=5,
                      fused_loss="on", gae_backend="pallas")
    algos = {d: MAPPO(cfg, EnvConfig(), device=d) for d in ("cpu", "cuda")}
    states = {d: a.init_state(seed=3) for d, a in algos.items()}
    for net in ("actor", "critic"):
        getattr(states["cuda"], net).load_state_dict(getattr(states["cpu"], net).state_dict())
    # sampled (not deterministic) actions: with actions equal to the mean the
    # first-epoch actor gradient is exactly zero and Adam would normalize
    # rounding noise into full-size steps
    traj = algos["cpu"].rollout(states["cpu"], 4)
    metrics = {}
    for d, algo in algos.items():
        tr = type(traj)(*(t.to(d) for t in traj))
        adv, ret = algo.compute_returns(states[d], tr)
        metrics[d] = algo.update(states[d], tr, adv, ret).cpu()
    worst = 0.0
    for net in ("actor", "critic"):
        a = getattr(states["cpu"], net).state_dict()
        b = getattr(states["cuda"], net).state_dict()
        for key in a:
            worst = max(worst, float((a[key] - b[key].cpu()).abs().max()))
    # f32 summation order over 128 rows, two Adam steps of lr ~4e-4
    if worst > 1e-5 or not torch.allclose(metrics["cpu"], metrics["cuda"], rtol=1e-3,
                                          atol=1e-5):
        raise SmokeFailure(f"GPU update differs from CPU: params {worst:.3e}, metrics "
                           f"{metrics['cpu'].tolist()} vs {metrics['cuda'].tolist()}")
    print(f"  fused f32 update, GPU vs CPU: max |param diff| {worst:.3e}, metrics "
          f"{[round(x, 6) for x in metrics['cuda'].tolist()]}", flush=True)


def train_runs(results: dict):
    import torch

    from dcc_tpu_torch import train
    from dcc_tpu_torch.ops import LAUNCHES, reset_launches

    base = ["--n-iters", "2", "--save-gifs", "false", "--save-model", "false",
            "--n-eval-rollout-threads", "0", "--seed", "0"]
    for tag, extra in (("f32", []), ("bf16", ["--compute-dtype", "bfloat16"])):
        print(f"--- train, {tag}: python -m dcc_tpu_torch.train {' '.join(base + extra)}",
              flush=True)
        reset_launches()
        t0 = time.perf_counter()
        learner = train.main(base + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        m = learner.last_metrics._asdict()
        if not all(math.isfinite(v) for v in m.values()):
            raise SmokeFailure(f"non-finite training metrics ({tag}): {m}")
        results[tag] = dict(metrics=m, launches=counts, wall_s=wall,
                            phases=learner.timer.summary())
        print(f"  launches {counts}; wall {wall:.2f} s", flush=True)
    need = ("gae", "fused_mlp", "actor_ppo_grads", "critic_ppo_grads")
    missing = [k for k in need if results["bf16"]["launches"].get(k, 0) == 0]
    if missing:
        raise SmokeFailure(f"bf16 main path never launched {missing}")
    if results["f32"]["launches"].get("gae", 0) == 0:
        raise SmokeFailure("f32 main path never launched the GAE kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v output")
    ap.add_argument("--out", default=None, help="also write all results to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from dcc_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the dcc_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.chdir(ROOT)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card}; {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build(verbose=args.ptxas)
    print(f"[2] built {sorted(k for k in built if not k.startswith('_'))} in "
          f"{built['_seconds']:.1f} s ({time.perf_counter() - t0:.1f} s with hashing)",
          flush=True)

    checks: list = []
    print("[3] kernels against their plain versions", flush=True)
    check_kernels(checks)
    print("[4] fused update on the card against the CPU", flush=True)
    check_update_against_cpu()
    print("[5] training through dcc_tpu_torch.train", flush=True)
    runs: dict = {}
    train_runs(runs)

    kernels = []
    for name in ("gae", "fused_mlp", "actor_ppo_grads", "critic_ppo_grads"):
        mode = "f32" if name == "gae" else "bf16"
        row = next(c for c in checks if c["kernel"] == name and c["mode"] == mode
                   and c["envs"] == 16)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=runs["bf16"]["launches"].get(name, 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
            mode=mode, shape=row["shape"],
        ))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kind=kind, torch=torch.__version__,
                           build_s=built["_seconds"], checks=checks, train=runs,
                           kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
