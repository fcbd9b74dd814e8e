#!/usr/bin/env python3
"""How the recurrent bf16 update of ``chip_smoke.py``'s check against the
CPU responds to the summation order of K2b's products, on the CPU.

    python scripts/update_order_check.py

Runs that check's update (same config, seed and init parameters) on the CPU
with the plain K2b, then again with K2b's products summed another way and
prints the largest parameter gaps against the first run (the check bounds
them by 3e-4):

* ``grouped``: every product of the plain K2b summed in 16-deep exact groups,
  each added to the f32 accumulator with one rounding (the order of the
  tensor cores' mma.sync);
* ``grouped forward``: only the forward recompute's products grouped;
* ``grouped, uncertain re-summed``: grouped, but each relu pre-activation
  that the tensor-core K2b's ``relu_uncertain`` flags re-summed in sequential
  order, as that kernel does.

It also prints each first-layer pre-activation whose relu side differs
between the sequential and the grouped order, with its exact sum.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig  # noqa: E402
from dcc_tpu_torch.envs import EnvConfig  # noqa: E402
from dcc_tpu_torch.ops import fused_mlp as FM  # noqa: E402

PLAIN = FM.trunk_backward_plain
CFG = MAPPOConfig(compute_dtype="bfloat16", use_recurrent_policy=True, data_chunk_length=4,
                  fused_trunk="on", n_rollout_threads=4, episode_length=8, ppo_epoch=2,
                  n_iters=5, gae_backend="pallas")


def sequential(p, q):
    """f32 sums in k order, one rounding per term (bf16 products are exact)."""
    acc = torch.zeros(p.shape[0], q.shape[1])
    for k in range(p.shape[1]):
        acc = (acc.double() + p[:, k:k + 1].double() * q[k:k + 1].double()).float()
    return acc


def grouped(p, q):
    acc = torch.zeros(p.shape[0], q.shape[1])
    for k in range(0, p.shape[1], 16):
        part = (p[:, k:k + 16].double() @ q[k:k + 16].double()).float()
        acc = (acc.double() + part.double()).float()
    return acc


def uncertain(acc, b, p, q):
    """``relu_uncertain`` of csrc/fused_mlp_bwd.cu, elementwise."""
    z = FM.bf16_round(FM.bf16_round(acc) + FM.bf16_round(b))
    step = torch.exp2(torch.floor(torch.log2(acc.abs().clamp_min(1e-30))) - 7)
    bound = 2.0 ** -14 * p.norm(dim=1, keepdim=True) * q.norm(dim=0, keepdim=True)
    return (z.abs() <= step) | (acc.abs() <= bound)


def k2b(mode):
    """The plain K2b with its f32 products summed as ``mode`` says."""
    def backward(x, params, g, n_layers, use_fn=True, use_relu=True, bf16=False):
        matmul, calls = torch.Tensor.__matmul__, [0]
        first = 2 if use_fn else 0

        def mm(p, q):
            if p.dtype != torch.float32 or q.dtype != torch.float32 or p.dim() != 2:
                return matmul(p, q)
            i = calls[0]
            calls[0] += 1
            fwd = i < n_layers  # the forward recompute's products come first
            if mode == "grouped forward" and not fwd:
                return matmul(p, q)
            acc = grouped(p, q)
            if mode == "grouped, uncertain re-summed" and fwd:
                flag = uncertain(acc, params[first + 4 * i + 1], p, q)
                acc = torch.where(flag, sequential(p, q), acc)
            return acc

        torch.Tensor.__matmul__ = mm
        try:
            return PLAIN(x, params, g, n_layers, use_fn, use_relu, bf16)
        finally:
            torch.Tensor.__matmul__ = matmul
    return backward


def update(backward, spy=None):
    FM.trunk_backward_plain = spy or backward
    try:
        algo = MAPPO(CFG, EnvConfig(), device="cpu")
        state = algo.init_state(seed=3)
        traj = algo.rollout(state, 4)
        adv, ret = algo.compute_returns(state, traj)
        algo.update(state, traj, adv, ret)
    finally:
        FM.trunk_backward_plain = PLAIN
    return {f"{net}.{k}": v for net in ("actor", "critic")
            for k, v in getattr(state, net).state_dict().items()}


def main() -> int:
    calls = []

    def spy(x, params, g, *args):
        calls.append((x.clone(), [p.detach().clone() for p in params]))
        return PLAIN(x, params, g, *args)

    ref = update(PLAIN, spy)
    for mode in ("grouped", "grouped forward", "grouped, uncertain re-summed"):
        got = update(k2b(mode))
        gaps = sorted(((float((ref[k] - got[k]).abs().max()), k) for k in ref), reverse=True)
        print(f"{mode:30s} largest gaps: " + ", ".join(f"{n} {g:.3e}" for g, n in gaps[:3]))
    rnd = FM.bf16_round
    for ci, (x, params) in enumerate(calls):
        mu, inv = FM.ln_stats(x.float())
        a = rnd((x.float() - mu) * inv * params[0] + params[1])
        w, b = rnd(params[2]), params[3]
        zs = rnd(rnd(sequential(a, w)) + rnd(b))
        zg = rnd(rnd(grouped(a, w)) + rnd(b))
        for r, c in ((zs > 0) != (zg > 0)).nonzero().tolist():
            terms = a[r].double() * w[:, c].double()
            one = (a[r:r + 1], w[:, c:c + 1])
            print(f"K2b call {ci} ({x.shape[0]} x {x.shape[1]}), row {r}, column {c}: bias "
                  f"{float(b[c]):.3g}, sequential sum {float(sequential(*one)):.3e}, grouped "
                  f"{float(grouped(*one)):.3e}, exact {float(terms.sum()):.3e}, sum of |terms| "
                  f"{float(terms.abs().sum()):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
