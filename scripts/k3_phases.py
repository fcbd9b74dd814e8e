#!/usr/bin/env python3
"""Where the bf16 K3 kernel (``actor_grads_mma_kernel``, whose body
``ppo_grads_mma`` it shares with K4) spends a row tile, on one GPU.

    python3 scripts/k3_phases.py [--rows 38400]

Copies ``dcc_tpu_torch`` to ``build/k3_phases/``, inserts ``clock64()``
checkpoints (each after a block-wide barrier) between the phases of the
kernel's tile loop in the copy's ``csrc/fused_ppo.cu``, builds it, runs K3
on random actor rows at the default widths and prints the SM cycles of
each phase for block 0's first tile (which stores its gradient slot) and
second tile (which adds into it). The barriers the checkpoints add make the
instrumented kernel slower than the real one, whose time per call is
printed last for comparison. The repository's own sources are not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(ROOT, "build", "k3_phases")
PHASES = ["load input", "forward L0 product", "L0 epilogue", "forward L1 product",
          "L1 epilogue", "head + loss", "head grads + cotangent", "LN bwd L1",
          "dV/du L1 into slot", "g_prev L1 product", "LN bwd L0", "dV/du L0 into slot"]
CHECKPOINTS = [  # (anchor, checkpoint inserted after it), found in this order
    ("    load_input<BR>(x, x_bf16, row0, R, d_in, Kp0, use_fn, nullptr, nullptr, a0, lda0);\n"
     "    __syncthreads();\n", "    DBG(1);\n"),
    ("                         wb + woffs[li], Hp, Hp, ring, wt, acc);\n",
     "      DBG(2 + 2 * li);\n"),
    ("      __syncthreads();\n    }\n    if (!first", None),
    ("\n    __syncthreads();\n", "    DBG(6);\n"),  # the barrier after the head
    ("        acc[nt][i] = g;\n      }\n    }\n", "    DBG(7);\n"),
    ("      __syncthreads();\n      // du = column sums of the un-rounded cotangent\n",
     "      DBG(8 + 3 * (1 - li));\n"),
    ("                    li == 0 ? d_in : H, gs, ldh, Hp, H, UNF ? sb + o[0] : fslot.v(li), first);\n",
     "      DBG(9 + 3 * (1 - li));\n"),
    ("        gemm_stream<true>(gs, ldh, Hp, wb + woffs[li], Hp, Hp, ring, wt, acc);\n",
     "      DBG(10 + 3 * (1 - li));\n"),
]


def instrument(src: str) -> str:
    head = ("__device__ unsigned long long k3_clock[2][16];\n"
            "#define DBG(i) do { __syncthreads(); if (threadIdx.x == 0 && blockIdx.x == 0 && "
            "nth < 2) k3_clock[nth][i] = clock64(); } while (0)\n"
            "extern \"C\" int dcc_k3_clock(unsigned long long* out) {\n"
            "  return (int)cudaMemcpyFromSymbol(out, k3_clock, sizeof(k3_clock));\n}\n")
    k = src.index("ppo_grads_mma(unsigned char* smem_raw")
    pre, body = src[:k], src[k:]
    loop = "  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
    assert loop in body, "tile loop not found"
    body = body.replace(loop, "  int nth = -1;\n" + loop + "    ++nth;\n    DBG(0);\n", 1)
    at = 0
    for anchor, probe in CHECKPOINTS:
        i = body.find(anchor, at)
        assert i >= 0, f"anchor not found: {anchor!r}"
        if probe is None:  # the end of the forward's layer loop
            text = anchor.replace("    }\n", "      DBG(3 + 2 * li);\n    }\n", 1)
        else:
            text = anchor + probe
        body = body[:i] + text + body[i + len(anchor):]
        at = i + len(text)
    s = pre.replace("struct PpoMmaLayout {", head + "struct PpoMmaLayout {", 1)
    return s + body


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=38400, help="actor rows (T*E*A)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dcc_tpu_torch"), os.path.join(COPY, "dcc_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(COPY, "dcc_tpu_torch", "csrc", "fused_ppo.cu")
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(instrument(src))
    sys.path.insert(0, COPY)
    from dcc_tpu_torch.algos.mappo import MAPPO, MAPPOConfig
    from dcc_tpu_torch.envs import EnvConfig
    from dcc_tpu_torch.ops import cuda_build as cb
    from dcc_tpu_torch.ops import fused_ppo as FP

    assert cb.CSRC.startswith(COPY), cb.CSRC
    dev = torch.device("cuda")
    env = EnvConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    algo = MAPPO(MAPPOConfig(compute_dtype="bfloat16", fused_loss="on", fused_trunk="on"), env,
                 device=dev)
    actor, _ = algo.make_networks(seed=2)
    kp, whf, bhf = FP.fold_trunk([p.detach() for p in actor.base.flat_params()],
                                 actor.act_out.weight.detach().t(),
                                 actor.act_out.bias.detach(), 2, True)
    R = args.rows
    obs = torch.randn(R, env.obs_dim, generator=gen, device=dev).bfloat16()
    aux = FP.pack_actor_aux(0.5 * torch.randn(R, 2, generator=gen, device=dev),
                            -2.0 + 0.3 * torch.randn(R, 1, generator=gen, device=dev),
                            torch.randn(R, 1, generator=gen, device=dev))
    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=True, clip_param=0.2)
    for _ in range(3):
        FP.actor_grads_cuda(obs, aux, kp, whf, bhf, actor.log_std.detach(), **kw)
    torch.cuda.synchronize()
    lib = cb.library("fused_ppo")
    lib.dcc_k3_clock.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 32)()
    if lib.dcc_k3_clock(buf) != 0:
        raise RuntimeError("could not read the checkpoints")
    card = torch.cuda.get_device_name(0)
    print(f"{card}; K3 bf16 on {R} x {env.obs_dim} rows, SM cycles per phase of block 0")
    for t, what in enumerate(("first tile (stores its slot)", "second tile (adds into it)")):
        v = list(buf[16 * t: 16 * t + 16])
        if v[13] == 0:
            print(f"  {what}: block 0 ran no such tile")
            continue
        print(f"  {what}: total {v[13] - v[0]} cycles")
        for i, name in enumerate(PHASES):
            print(f"    {v[i + 1] - v[i]:9d}  {name}")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        FP.actor_grads_cuda(obs, aux, kp, whf, bhf, actor.log_std.detach(), **kw)
    end.record()
    end.synchronize()
    print(f"  instrumented kernel: {start.elapsed_time(end) / 10:.3f} ms per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
