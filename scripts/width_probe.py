#!/usr/bin/env python3
"""K3 / K4 (folded) against their plain versions at many row widths, on one
GPU: which widths, activations and losses move the kernels' readings.

    python3 scripts/width_probe.py [--out FILE] [--flips]

For each (kernel, width, rows, dtype) and each variant -- relu with the
kink rule of the smoke, tanh (no relu kink), and relu with the clip range
so wide that no row sits at a clip bound (K3) -- prints each output
tensor's ||kernel - plain|| / ||plain||, the rows the kink rule took out,
and the rows whose pre-activations lie within 1e-5 (f32) of the kink.
With ``--flips``, for a few bf16 actor cases: each 64-row chunk's reading
(the kernel and the plain version on the chunk's rows alone), each row's
reading in the worst chunks, and each such row's distance from a relu kink
in the plain forward (min over layers and units of |z| over the bf16
spacing at its accumulator); then the full reading with those rows' advantage
zeroed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(g, w):
    g, w = g.float(), w.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--flips", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("width_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops import fused_ppo as FP

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    H, L = 256, 2
    results = []

    def params(gen, d_in):
        rnd = lambda *s, scale=1.0: (scale * torch.randn(s, generator=gen)).to(dev)
        p = [1.0 + rnd(d_in, scale=0.1), rnd(d_in, scale=0.1)]
        d = d_in
        for _ in range(L):
            p += [rnd(d, H, scale=d ** -0.5), rnd(H, scale=0.1), 1.0 + rnd(H, scale=0.1),
                  rnd(H, scale=0.1)]
            d = H
        return p

    if args.flips:
        return flips(params, dev, H, L)
    for kind in ("actor", "critic"):
        for d_in in (58, 64, 110, 122, 128, 174, 192, 960, 1220):
            for rows in (2400, 9600, 24000):
                for bf16 in (False, True):
                    for variant in ("relu", "tanh", "noclip"):
                        if variant == "noclip" and kind == "critic":
                            continue
                        gen = torch.Generator().manual_seed(d_in * 7 + rows)
                        prm = params(gen, d_in)
                        n_out = 2 if kind == "actor" else 1
                        hw = (0.1 * torch.randn(H, n_out, generator=gen)).to(dev)
                        hb = (0.1 * torch.randn(n_out, generator=gen)).to(dev)
                        kp, whf, bhf = FP.fold_trunk(prm, hw, hb, L, True)
                        x = torch.randn(rows, d_in, generator=gen).to(dev)
                        x = x.bfloat16() if bf16 else x
                        relu = variant != "tanh"
                        clip = 1e9 if variant == "noclip" else 0.2
                        if kind == "actor":
                            aux = FP.pack_actor_aux(
                                (0.5 * torch.randn(rows, 2, generator=gen)).to(dev),
                                (-2.0 + 0.3 * torch.randn(rows, 1, generator=gen)).to(dev),
                                torch.randn(rows, 1, generator=gen).to(dev))
                            col = 3
                        else:
                            vp = torch.randn(rows, 1, generator=gen)
                            aux = FP.pack_critic_aux(vp.to(dev), (vp + 3.0 * torch.randn(
                                rows, 1, generator=gen)).to(dev))
                            col = 2
                        kink = torch.zeros(rows, dtype=torch.bool, device=dev)
                        if relu and bf16:
                            kink = FP.relu_kink_rows_folded(x, kp, L, True)
                            aux[kink, col] = 0.0
                        # f32 rows within 1e-5 of a kink (not taken out)
                        with torch.no_grad():
                            _, cache = FP._fwd_folded(x, kp, L, True, True, False)
                            near = torch.zeros(rows, dtype=torch.bool, device=dev)
                            for li, (a, *_) in enumerate(cache):
                                z = FP.dense(a, kp[2 * li], kp[2 * li + 1], False)
                                near |= (z.abs() < 1e-5).any(dim=1)
                        kw = dict(n_layers=L, use_fn=True, use_relu=relu, bf16=bf16,
                                  clip_param=clip)
                        cb.reset_launches()
                        if kind == "actor":
                            ls = torch.tensor([-0.3, 0.2], device=dev)
                            got = FP.actor_grads_cuda(x, aux, kp, whf, bhf, ls, **kw)
                            want = FP.actor_grads_plain(x, aux, kp, whf, bhf, ls, **kw)
                        else:
                            norm = torch.tensor([0.5, 2.0], device=dev)
                            ckw = dict(kw, huber_delta=10.0, use_huber=True, use_clipped=True)
                            got = FP.critic_grads_cuda(x, aux, norm, kp, whf, bhf, **ckw)
                            want = FP.critic_grads_plain(x, aux, norm, kp, whf, bhf, **ckw)
                        tile = cb.TILE.get(f"{kind}_ppo_grads")
                        rels = [rel(g, w) for g, w in zip([*got[0], *got[1:]],
                                                          [*want[0], *want[1:]])]
                        row = dict(kind=kind, d_in=d_in, rows=rows, bf16=bf16, variant=variant,
                                   tile=tile, kink_rows=int(kink.sum()),
                                   near_f32=int(near.sum()), rel=rels)
                        results.append(row)
                        print(f"{kind:6s} d_in={d_in:5d} rows={rows:6d} "
                              f"{'bf16' if bf16 else 'f32 '} {variant:6s} tile={tile} "
                              f"kink={int(kink.sum()):6d} near_f32={int(near.sum()):3d} max "
                              f"rel={max(rels):.3e} at [{rels.index(max(rels))}]", flush=True)
                        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


def kink_ulps(x, kp, L):
    """Per row: min over layers and units of |z| / (bf16 spacing at |acc|)
    in the plain bf16 folded forward."""
    import torch

    from dcc_tpu_torch.ops import fused_ppo as FP

    with torch.no_grad():
        _, cache = FP._fwd_folded(x, kp, L, True, True, True)
        best = torch.full((x.shape[0],), float("inf"), device=x.device)
        for li, (a, *_) in enumerate(cache):
            z = FP.dense(a, kp[2 * li], kp[2 * li + 1], True)
            acc = FP._mm(a, kp[2 * li], True).abs().clamp_min(1e-30)
            sp = torch.exp2(torch.floor(torch.log2(acc)) - 7)
            best = torch.minimum(best, (z.abs() / sp).min(dim=1).values)
    return best


def flips(params, dev, H, L):
    import torch

    from dcc_tpu_torch.ops import fused_ppo as FP

    ls = torch.tensor([-0.3, 0.2], device=dev)
    for d_in, rows, clip in ((58, 2400, 0.2), (122, 9600, 0.2), (1220, 2400, 0.2),
                             (192, 9600, 1e9), (110, 9600, 0.2)):
        gen = torch.Generator().manual_seed(d_in * 7 + rows)
        prm = params(gen, d_in)
        hw = (0.1 * torch.randn(H, 2, generator=gen)).to(dev)
        hb = (0.1 * torch.randn(2, generator=gen)).to(dev)
        kp, whf, bhf = FP.fold_trunk(prm, hw, hb, L, True)
        x = torch.randn(rows, d_in, generator=gen).to(dev).bfloat16()
        aux = FP.pack_actor_aux((0.5 * torch.randn(rows, 2, generator=gen)).to(dev),
                                (-2.0 + 0.3 * torch.randn(rows, 1, generator=gen)).to(dev),
                                torch.randn(rows, 1, generator=gen).to(dev))
        aux[FP.relu_kink_rows_folded(x, kp, L, True), 3] = 0.0
        kw = dict(n_layers=L, use_fn=True, use_relu=True, bf16=True, clip_param=clip)

        def reading(idx):
            got = FP.actor_grads_cuda(x[idx].contiguous(), aux[idx].contiguous(), kp, whf,
                                      bhf, ls, **kw)
            want = FP.actor_grads_plain(x[idx], aux[idx], kp, whf, bhf, ls, **kw)
            return max(rel(g, w) for g, w in zip([*got[0], *got[1:]],
                                                 [*want[0], *want[1:]]))

        everything = torch.arange(rows, device=dev)
        full = reading(everything)
        chunks = everything.split(64)
        cr = torch.tensor([reading(c) for c in chunks])
        order = torch.argsort(cr, descending=True)
        ulps = kink_ulps(x, kp, L)
        print(f"d_in={d_in} rows={rows} clip={clip}: full {full:.3e}; chunk readings median "
              f"{float(cr.median()):.3e}, top {[round(float(v), 4) for v in cr[order[:8]]]}",
              flush=True)
        bad = []
        for ci in order[:6].tolist():
            rr = [(int(r), reading(r.reshape(1)), float(ulps[r])) for r in chunks[ci]]
            rr.sort(key=lambda t: -t[1])
            print(f"  chunk {ci} ({float(cr[ci]):.3e}): top rows (row, reading, kink ulps) "
                  f"{[(r, round(v, 4), round(u, 2)) for r, v, u in rr[:4]]}; median row "
                  f"{sorted(v for _, v, _ in rr)[len(rr) // 2]:.3e}", flush=True)
            bad += [r for r, v, _ in rr if v > 0.25]
        if bad:
            aux2 = aux.clone()
            aux2[bad, 3] = 0.0
            aux_saved = aux.clone()
            aux.copy_(aux2)
            print(f"  with the {len(bad)} rows above 0.25 zeroed: full {reading(everything):.3e}",
                  flush=True)
            aux.copy_(aux_saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
