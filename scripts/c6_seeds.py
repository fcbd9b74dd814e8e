#!/usr/bin/env python3
"""ROADMAP C6 over seeds: the two bf16 kernel readings that met their bound
only on the data one smoke drew, each drawn again from several seeds on one
GPU, with ``chip_smoke.py``'s bounds and relu mask rule unchanged.

    python3 scripts/c6_seeds.py [--seeds 8] [--rows 38400 153600] [--out FILE]

1. The chunked K4 (``ops.fused_ppo.critic_grads_cuda``: the chunked kernel,
   then the dV0 kernel) at hidden 512 on the 20-UAV preset's 4,840-wide
   critic rows, the model's relu trunk (feature norm, two layers), data
   drawn as ``chip_smoke.check_ppo`` draws the critic's (nmb 1), under the
   relu mask rule (``chip_smoke.masked_relu``), every output held to
   ``chip_smoke.PPO_BF16_REL`` (4e-3) as ||k - p|| / ||p||; at each of
   ``--rows``.
2. The row-tiled layer-0 input backward with dx
   (``ops.fused_mlp.layer0_input_bwd_cuda(..., need_dx=True)``) at hidden
   1,024 on 512 x 17 bf16 rows with the feature norm, drawn as
   ``tests/test_torch_cuda.py::test_layer0_input_bwd_kernel_matches_plain``
   draws its operands, every output held to ``chip_smoke.DV0_REL`` (1e-4).

Seed s draws case 1 from a CUDA generator seeded 1000 + s and case 2 from a
CPU generator seeded s. Beside each reading, what tells its cause: for
case 1 the same plain version computed in f32 (on the kernel's relu
masks) against the bf16 plain version, per output, which is how far bf16
rounding alone moves each output on that draw, and each output's norm;
for case 2 the dx elements whose bf16 value differs from the plain
version's, and for them the largest distance of the plain version's f32
dx from the midpoint between the two bf16 values, relative to the value
(near 0: the two results round a near-tie apart). Prints every reading,
writes them to ``--out`` (JSON) and exits 1 if one exceeds its bound; a
relu mask beyond the rule counts as a reading past the bound.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

HIDDEN_K4 = 512
TAIL = (512, 17, 1024)  # rows, d_in, hidden of case 2


def _rels(got, want) -> list:
    return [float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
            for g, w in zip(got, want)]


def chunked_k4(seed: int, rows: int) -> dict:
    """Case 1 from seed ``seed`` on ``rows`` critic rows."""
    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops import fused_ppo as FP

    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    env = cs.env_config(cs.WIDE)
    D, H, L = env.n_agents * env.obs_dim, HIDDEN_K4, 2
    algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16", fused_loss="on", fused_trunk="on",
                             hidden_size=H), env, device="cuda")
    critic = algo.make_networks(seed=2)[1]
    cs.perturb_(critic, gen)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cent = randn(rows, D).to(torch.bfloat16)
    norm = torch.tensor([0.5, 2.0], device="cuda")
    with torch.no_grad():
        v0 = critic(cent[: min(rows, 65536)].float())
    vpred = randn(rows, 1) * float(v0.std() + 0.1)
    ret = vpred + 3.0 * randn(rows, 1)
    kp, wv, bv = FP.fold_trunk([p.detach() for p in critic.base.flat_params()],
                               critic.v_out.weight.detach().t(), critic.v_out.bias.detach(),
                               L, True)
    aux = FP.pack_critic_aux(vpred, ret)
    kw = dict(n_layers=L, use_fn=True, use_relu=True, bf16=True, clip_param=0.2,
              huber_delta=10.0, use_huber=True, use_clipped=True)
    kern = lambda **m: FP.critic_grads_cuda(cent, aux, norm, kp, wv, bv, **kw, **m)
    plain = lambda **m: FP.critic_grads_plain(cent, aux, norm, kp, wv, bv, **kw, **m)
    cb.reset_launches()
    out = dict(case="chunked K4", seed=seed, rows=rows, d_in=D, hidden=H,
               bound=cs.PPO_BF16_REL)
    try:
        k, p, (n_masks, mask_ratio) = cs.masked_relu(
            f"C6 chunked K4 seed {seed}, {rows} x {D} x {H}", kern, plain,
            lambda m: FP.relu_mask_gap_folded(cent, kp, L, True, m), L, rows, H)
    except cs.SmokeFailure as e:
        return dict(out, mask_fault=str(e), exceeds=True)
    flat = lambda o: [*o[0], *o[1:]]
    rels = _rels(flat(k), flat(p))
    # outputs: dV0, du0, dV1, du1, the value head's dw and db, the loss sum
    masks = torch.zeros((L, rows, H), dtype=torch.uint8, device="cuda")
    kern(relu_masks=masks)
    p32 = FP.critic_grads_plain(cent, aux, norm, kp, wv, bv, **{**kw, "bf16": False},
                                masks=masks)
    out.update(launches=dict(cb.LAUNCHES), masks_differ=n_masks, mask_ratio=mask_ratio,
               rels=rels, dv0_rel=rels[0], worst=max(rels),
               plain_bf16_vs_f32=_rels(flat(p), flat(p32)),
               norms=[float(t.float().norm()) for t in flat(p)],
               exceeds=max(rels) > cs.PPO_BF16_REL)
    return out


def row_tiled_dx(seed: int) -> dict:
    """Case 2 from seed ``seed``."""
    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops import fused_mlp as FM

    rows, d_in, hidden = TAIL
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d_in, generator=gen).cuda().bfloat16()
    xstats = FM.input_stats(x, True)
    g0 = torch.zeros(rows, FM.pad16(hidden), dtype=torch.bfloat16, device="cuda")
    g0[:, :hidden] = 0.1 * torch.randn(rows, hidden, generator=gen).cuda()
    w0 = torch.randn(d_in, hidden, generator=gen).cuda() * d_in ** -0.5
    w0b = FM.pack_mma_weights([w0], "cuda")[0].view(FM.pad16(d_in), FM.pad16(hidden))
    fs = (1.0 + 0.1 * torch.randn(d_in, generator=gen)).cuda()
    cb.reset_launches()
    got = FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, hidden, True)
    entry = cb.ENTRY.get("layer0_input_bwd")
    want = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, hidden, True)
    rels = _rels(got, want)  # dx, dfs, dfb
    # the plain version's dx before its bf16 rounding
    gp = g0[:, :hidden].float() @ w0b[:d_in, :hidden].float().t()
    xhat = (x.float() - xstats[:, :1]) * xstats[:, 1:]
    dx32 = FM._ln_bwd(gp, xhat, xstats[:, 1:], fs)[0]
    apart = got[0] != want[0]
    mid = (got[0][apart].float() + want[0][apart].float()) / 2
    tie = (dx32[apart] - mid).abs() / dx32[apart].abs().clamp_min(1e-30)
    return dict(case="row-tiled dx", seed=seed, rows=rows, d_in=d_in, hidden=hidden,
                bound=cs.DV0_REL, entry=entry, rels=rels, worst=max(rels),
                dx_elements_apart=int(apart.sum()), dx_elements=got[0].numel(),
                max_tie_distance=float(tie.max()) if tie.numel() else 0.0,
                exceeds=max(rels) > cs.DV0_REL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--rows", type=int, nargs="+", default=[38400, 153600])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("c6_seeds: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    t0 = time.perf_counter()
    readings = [row_tiled_dx(s) for s in range(args.seeds)]
    for rows in args.rows:
        for s in range(args.seeds):
            readings.append(chunked_k4(s, rows))
            torch.cuda.empty_cache()
    for r in readings:
        if "dv0_rel" in r:
            what = (f"masks apart {r['masks_differ']} (ratio {r['mask_ratio']:.3f}); plain "
                    f"bf16 vs f32 {[f'{x:.2e}' for x in r['plain_bf16_vs_f32']]}; norms "
                    f"{[f'{x:.3g}' for x in r['norms']]}")
        else:
            what = r.get("mask_fault") or (
                f"dx elements apart {r['dx_elements_apart']} of {r['dx_elements']}, their "
                f"f32 value at most {r['max_tie_distance']:.2e} from the bf16 midpoint")
        print(f"  {r['case']} seed {r['seed']} {r['rows']} x {r['d_in']} x {r['hidden']}: worst "
              f"{r.get('worst', float('nan')):.3e} of {r['bound']}; {what}; rels "
              f"{[f'{x:.2e}' for x in r.get('rels', [])]}"
              f"{'  EXCEEDS' if r['exceeds'] else ''}", flush=True)
    n_bad = sum(r["exceeds"] for r in readings)
    print(f"C6: {len(readings)} readings, {n_bad} past their bound, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=cs.card_line(), readings=readings), f, indent=1)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
