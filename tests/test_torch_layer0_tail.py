"""The layer-0 tail of the unfolded chunked chain (the chunked K2b, K3u and
K4u end in it: ``ops.fused_mlp.layer0_tail``, the layer-0 input backward
and dV0 in its affine mode) and the grid of its kernels
(``csrc/layer0_tail.cu``).

The tail's plain path on CPU tensors, fed the plain chunked K2b's layer-0
cotangent and row statistics (``trunk_bwd_chunked_plain``), gives the
feature norm's scale and bias gradients, W_0's gradient and dx of the JAX
package's backward kernel ``_bwd_kernel``, run interpreted through
``jax.grad`` of ``fused_mlp(interpret=True)`` and compiled with
``xla_allow_excess_precision`` off (which keeps its bf16 roundings as
written), within 1e-3 relative per tensor. The tail's own operands are the
same bf16 numbers on both sides; at these widths the chain above it
(summation orders of 1,510 to 4,840 products, then bf16 roundings) moves
the cotangent it starts from, as it moves the one-pass plain K2b's
(measured 0.87e-4 to 2.4e-4, dx up to 4.0e-4), while the tail computed on
the unrounded operands (the f32 xhat affine in dW0, the f32 W_0 in g_prev)
lies a bf16 step away (1.64e-3 to 1.72e-3, dx 2.56e-3), outside the bound,
which each case checks. The rows are 4,840 wide (the 20-UAV preset's
critic rows) and 1,510 (4 UAVs x 300 PoIs, actor rows), hidden 256 and
100, a relu layer with the feature norm, bf16; rows next to a relu kink
get a zero cotangent (``relu_kink_rows``).

The planner of the kernels' grid (``ops.tiles.tail_plan``) covers every
row, column of x and column of g0 exactly once in whole steps, and the
shared-memory mirror (``ops.tiles.tail_smem_bytes``) fits one block at the
presets' widths and ROADMAP B3's hidden widths. The card's tests hold the
kernels and the mirror against the library (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import tiles
from dcc_tpu_torch.ops.tiles import SMEM_MAX

ROWS = 40  # ragged against JAX's 16-row tile


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got.reshape(want.shape) - want) / max(np.linalg.norm(want), 1e-30))


def _case(d_in, hidden, seed):
    """bf16-valued rows, a one-layer relu trunk with the feature norm (its
    affine and biases off their init values) and a bf16 cotangent of its
    output, numpy f32."""
    rng = np.random.default_rng(seed)
    params = [1.0 + 0.1 * rng.normal(size=d_in), 0.1 * rng.normal(size=d_in),
              rng.normal(size=(d_in, hidden)) / np.sqrt(d_in), 0.1 * rng.normal(size=hidden),
              1.0 + 0.1 * rng.normal(size=hidden), 0.1 * rng.normal(size=hidden)]
    params = [p.astype(np.float32) for p in params]
    x = np.asarray(jnp.asarray(rng.normal(size=(ROWS, d_in)), jnp.bfloat16), np.float32)
    g = np.asarray(jnp.asarray(rng.normal(size=(ROWS, hidden)), jnp.bfloat16), np.float32)
    return x, params, g


TAIL_REL = 1e-3


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("d_in,hidden", [(4840, 256), (1510, 256), (4840, 100), (1510, 100)])
def test_layer0_tail_plain_matches_jax(d_in, hidden, need_dx):
    """dfs, dfb, dW0 (and dx) of the tail's plain path against JAX's
    interpreted backward kernel within ``TAIL_REL``; the tail on unrounded
    operands outside it."""
    x, params, g = _case(d_in, hidden, d_in + hidden)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = [torch.from_numpy(p) for p in params]
    g[FM.relu_kink_rows(tx, tp, 1, True, True).numpy()] = 0.0
    tg = torch.from_numpy(g)

    def loss(xx, *pp):
        out = j_fused_mlp(xx, list(pp), n_layers=1, use_feature_norm=True, use_relu=True,
                          bf16=True, block_rows=16, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g)

    args = (jnp.asarray(x, jnp.bfloat16), *[jnp.asarray(p) for p in params])
    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))
    jdx, jdfs, jdfb, jdw0 = grad.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    want = [np.asarray(t, np.float32) for t in (jdfs, jdfb, jdw0)]

    _, g0, xstats = FM.trunk_bwd_chunked_plain(tx, tp, tg, 1, use_fn=True, use_relu=True,
                                               bf16=True)
    w0b = FM.pack_mma_weights([tp[2]], "cpu")[0].view(FM.pad16(d_in), FM.pad16(hidden))
    dx, parts = FM.layer0_tail(tx, xstats, g0, w0b, tp[0], tp[1], hidden, need_dx)
    assert len(parts) == 3 and (dx is None) != need_dx
    for got, w in zip(parts, want):
        assert got.shape == w.shape and _rel(got.numpy(), w) < TAIL_REL
    if need_dx:
        assert dx.dtype == torch.bfloat16
        assert _rel(dx.float().numpy(), np.asarray(jdx, np.float32)) < TAIL_REL
    # the same tail on the unrounded operands
    w0f = torch.zeros(FM.pad16(d_in), FM.pad16(hidden))
    w0f[:d_in, :hidden] = tp[2]
    _, dfs, dfb = FM.layer0_input_bwd_plain(tx, xstats, g0, w0f, tp[0], hidden, False)
    xhat = (tx.float() - xstats[:, :1]) * xstats[:, 1:]
    dw0 = (xhat * tp[0] + tp[1]).t() @ g0[:, :hidden].float()
    for got, w in zip((dfs, dfb, dw0), want):
        assert _rel(got.numpy(), w) > TAIL_REL


# (rows, d_in, hidden): the wide runs' shapes (20-UAV 153,600 x 4,840, an
# update chunk 38,400, 16 envs 2,400; 4 x 300 PoIs 614,400 x 1,510 and
# 153,600 x 6,040), B3's widths at 4,840, and small ragged ones
PLAN_SHAPES = [(153600, 4840, 256), (38400, 4840, 256), (2400, 4840, 256),
               (614400, 1510, 256), (153600, 6040, 256), (153600, 4840, 512),
               (2400, 4840, 1024), (2400, 4840, 264), (20000, 4840, 100), (513, 1000, 64),
               (37, 17, 8), (1, 4840, 256), (511, 1510, 100)]


def _partition(spans, n):
    """The half-open spans cover [0, n) exactly once."""
    spans = sorted(s for s in set(spans) if s[1] > s[0])
    assert spans and spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


# the layer-0 input backward's tail kernel takes hidden widths to TAIL_HMAX
PLAN_CASES = [("dv0", *s) for s in PLAN_SHAPES] + [
    ("layer0_input_bwd", *s) for s in PLAN_SHAPES if FM.pad16(s[2]) <= tiles.TAIL_HMAX]


@pytest.mark.parametrize("kernel,rows,d_in,hidden", PLAN_CASES)
def test_tail_plan_covers_every_element_once(kernel, rows, d_in, hidden):
    """Every (row, column of x, column of g0) lies in exactly one block:
    the splits partition the rows in whole steps, each split's blocks
    partition x's columns (and, for dV0, g0's in passes of 256); the grid
    fills whole waves of 132 SMs to ``TAIL_WAVE_FILL`` where the rows allow
    as many splits."""
    sms = 132
    splits, split_rows, units = tiles.tail_plan(kernel, rows, d_in, hidden, sms)
    assert split_rows % tiles.TAIL_STEP[kernel] == 0 and 1 <= splits <= tiles.TAIL_MAX_SPLITS
    blocks = tiles.tail_blocks(kernel, rows, d_in, hidden, sms)
    assert len(blocks) == splits * units
    _partition([(r0, r1) for _, r0, r1, *_ in blocks], rows)
    by_split = {}
    for sp, r0, r1, k0, k1, n0, n1 in blocks:
        by_split.setdefault(sp, []).append((k0, k1, n0, n1))
    for cols in by_split.values():
        for k in {(k0, k1) for k0, k1, _, _ in cols}:
            _partition([(n0, n1) for k0, k1, n0, n1 in cols if (k0, k1) == k], hidden)
        _partition([(k0, k1) for k0, k1, _, _ in cols], d_in)
    if -(-rows // tiles.TAIL_STEP[kernel]) >= splits and splits * units >= sms:
        waves = -(-(splits * units) // sms)
        assert splits * units / (waves * sms) >= tiles.TAIL_WAVE_FILL or \
            splits == tiles.TAIL_MAX_SPLITS


@pytest.mark.parametrize("xmode", tiles.TAIL_XMODES)
@pytest.mark.parametrize("hidden", [8, 64, 100, 122, 192, 256, 264, 300, 512, 1024])
def test_tail_smem_fits_one_block(hidden, xmode):
    """One block of each tail kernel fits an H100 block's shared memory at
    the presets' hidden widths and B3's (the layer-0 input backward's tail
    kernel to 256, where it is taken), in each way x is copied; dV0's does
    not grow with H."""
    dv0 = tiles.tail_smem_bytes("dv0", xmode, hidden)
    assert dv0 <= SMEM_MAX and dv0 == tiles.tail_smem_bytes("dv0", xmode, 8)
    if FM.pad16(hidden) <= tiles.TAIL_HMAX:
        assert tiles.tail_smem_bytes("layer0_input_bwd", xmode, hidden) <= SMEM_MAX

