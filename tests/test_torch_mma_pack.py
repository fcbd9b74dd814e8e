"""The CPU side of the bf16 tensor-core kernels (K2 forward, K2b backward,
K3 actor, K4 critic): the padded bf16 weight copies, the padding algebra the
kernels rely on, the per-version cache of ``MLPBase.packed_params``, K3's
and K4's packing, their row tiles and block counts, and the relu kink rules
of their checks.

The kernels read each weight as a bf16 copy zero-padded to multiples of 16
in both dimensions, feed zero-padded activation columns, take LayerNorm
statistics over the real width only and write the padded columns of every
LN output and cotangent as 0. The padded chains below do exactly that in
PyTorch, with the products in float64, where the sums of bf16 x bf16
products are exact; each must equal its unpadded twin bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from dcc_tpu_torch.models import MLPBase
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops import tiles
from test_torch_cuda import smem_layout


def _mats(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("shapes", [[(110, 256), (256, 256)], [(440, 256), (256, 256)],
                                    [(37, 64)], [(45, 72), (72, 72), (72, 72)]])
def test_mma_weight_pack_pads_and_rounds(shapes):
    mats = _mats(shapes)
    buf, offs = FM.pack_mma_weights(mats, "cpu")
    assert buf.dtype == torch.bfloat16
    o = 0
    for w, off in zip(mats, offs):
        k, n = FM.pad16(w.shape[0]), FM.pad16(w.shape[1])
        assert off == o and k % 16 == 0 and n % 16 == 0
        block = buf[off : off + k * n].view(k, n).float()
        assert torch.equal(block[: w.shape[0], : w.shape[1]], FM.bf16_round(w))
        assert not block[w.shape[0]:].any() and not block[:, w.shape[1]:].any()
        o += k * n
    assert buf.numel() == o


def _ln(r, h):
    """Stats over the first h columns; xhat over those, 0 beyond."""
    real = r[:, :h]
    mu = real.mean(dim=1, keepdim=True)
    inv = torch.rsqrt(torch.clamp((real * real).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
                      + FM.EPS)
    xhat = torch.zeros_like(r)
    xhat[:, :h] = (real - mu) * inv
    return xhat


def _chain(x, ws, bs, scales, shifts, hidden, pad):
    """bf16 trunk with f64 products, on padded operands when ``pad``."""
    rnd = FM.bf16_round
    a = rnd(FM.ln_stats(x)[1] * (x - FM.ln_stats(x)[0]))
    for w, b, s, c in zip(ws, bs, scales, shifts):
        if pad:
            a = torch.nn.functional.pad(a, (0, w.shape[0] - a.shape[1]))
            b = torch.nn.functional.pad(b, (0, w.shape[1] - b.shape[0]))
            s = torch.nn.functional.pad(s, (0, w.shape[1] - s.shape[0]))
            c = torch.nn.functional.pad(c, (0, w.shape[1] - c.shape[0]))
        z = rnd(rnd((rnd(a).double() @ rnd(w).double()).float()) + rnd(b))
        r = torch.relu(z)
        y = _ln(r, hidden) * s + c
        if pad:
            y[:, hidden:] = 0.0
        a = rnd(y)
    return a[:, :hidden]


@pytest.mark.parametrize("d_in,hidden,n_layers", [(110, 256, 2), (440, 256, 2),
                                                  (37, 64, 1), (45, 72, 3)])
def test_padded_chain_equals_unpadded(d_in, hidden, n_layers):
    rng = np.random.default_rng(1)
    shapes = [(d_in, hidden)] + [(hidden, hidden)] * (n_layers - 1)
    ws = [w / np.sqrt(w.shape[0]) for w in _mats(shapes, seed=2)]
    vec = lambda: torch.from_numpy((0.1 * rng.normal(size=hidden)).astype(np.float32))
    bs, scales, shifts = [vec() for _ in ws], [1.0 + vec() for _ in ws], [vec() for _ in ws]
    x = torch.from_numpy(rng.normal(size=(33, d_in)).astype(np.float32))
    buf, offs = FM.pack_mma_weights(ws, "cpu")
    padded = [buf[o : o + FM.pad16(w.shape[0]) * FM.pad16(w.shape[1])].view(
        FM.pad16(w.shape[0]), FM.pad16(w.shape[1])).float() for w, o in zip(ws, offs)]
    want = _chain(x, ws, bs, scales, shifts, hidden, pad=False)
    got = _chain(x, padded, bs, scales, shifts, hidden, pad=True)
    assert torch.equal(got, want)


def test_trunk_pack_carries_bf16_weights_per_version():
    """In bf16 the K2 pack holds the padded bf16 weights beside the f32
    buffer; it is reused until an optimizer step changes a parameter."""
    m = MLPBase(110, hidden_size=64, layer_n=1, bf16=True, fused=True)
    first = m.packed_params("cpu")
    assert m.packed_params("cpu") is first
    flat = m.flat_params()
    want_w, want_o = FM.pack_mma_weights([flat[2], flat[6]], "cpu")
    assert torch.equal(first.weights, want_w) and first.weight_offsets == want_o
    assert torch.equal(first.buffer, FM.pack_params(flat, "cpu")[0])
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    again = m.packed_params("cpu")
    assert again is not first and not torch.equal(again.weights, first.weights)
    flat = m.flat_params()
    assert torch.equal(again.weights, FM.pack_mma_weights([flat[2], flat[6]], "cpu")[0])
    assert m.packed_params("cpu") is again
    twin = copy.deepcopy(m)
    assert MLPBase(110, hidden_size=64, layer_n=1, fused=True).packed_params("cpu").weights is None
    assert torch.equal(twin.packed_params("cpu").weights, again.weights)


@pytest.mark.parametrize("mma", [False, True])
def test_actor_kernel_params(mma):
    """K3's packing: the FMA kernel reads V and V^T from the f32 buffer, the
    tensor-core kernel the padded bf16 V's, with empty f32 V slots."""
    d_in, hidden = 37, 64
    ws = _mats([(d_in, hidden), (hidden, hidden)], seed=5)
    us = _mats([(hidden,), (hidden,)], seed=6)
    head = _mats([(hidden, 2), (2,), (2,)], seed=7)
    kp = [ws[0], us[0], ws[1], us[1]]
    pb, offs, wb, woffs = FP._kernel_params(kp, head, "cpu", mma)
    n_v = 0 if mma else ws[0].numel() + 2 * ws[1].numel()
    assert pb.numel() == n_v + 2 * hidden + sum(h.numel() for h in head)
    assert torch.equal(pb[offs[2] : offs[2] + hidden], us[0])
    assert torch.equal(pb[offs[-3]:].view(-1)[: 2 * hidden], head[0].reshape(-1))
    if mma:
        assert offs[0] == offs[1] == offs[2]
        assert torch.equal(wb, FM.pack_mma_weights(ws, "cpu")[0])
    else:
        assert wb is None and woffs is None
        assert torch.equal(pb[offs[4] : offs[5]].view(hidden, hidden), ws[1].t())


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_critic_kernel_params_for_the_tensor_cores(n_layers):
    """K4's packing for its tensor-core kernel: the padded bf16 V's at the
    critic's 440-wide rows (448 x 256, then 256 x 256), empty f32 V slots,
    each u where the kernel reads it (offs[3 li + 2]) and the value head's
    wv (H) and bv after the trunk (offs[3L], offs[3L + 1])."""
    d_in, hidden = 440, 256
    ws = _mats([(d_in, hidden)] + [(hidden, hidden)] * (n_layers - 1), seed=12)
    us = _mats([(hidden,)] * n_layers, seed=13)
    wv, bv = _mats([(hidden, 1), (1,)], seed=14)
    kp = [t for pair in zip(ws, us) for t in pair]
    pb, offs, wb, woffs = FP._kernel_params(kp, [wv, bv], "cpu", mma=True)
    assert len(offs) == 3 * n_layers + 2 and pb.numel() == n_layers * hidden + hidden + 1
    for li in range(n_layers):
        assert offs[3 * li] == offs[3 * li + 1] == offs[3 * li + 2]
        assert torch.equal(pb[offs[3 * li + 2] : offs[3 * li + 2] + hidden], us[li])
    assert torch.equal(pb[offs[3 * n_layers] : offs[3 * n_layers] + hidden], wv[:, 0])
    assert float(pb[offs[3 * n_layers + 1]]) == float(bv[0])
    want_w, want_o = FM.pack_mma_weights(ws, "cpu")
    assert torch.equal(wb, want_w) and woffs == want_o
    assert woffs[1:] == [448 * 256 + (li - 1) * 256 * 256 for li in range(1, n_layers)]


@pytest.mark.parametrize("hidden", [36, 264])
def test_mma_width_check(monkeypatch, hidden):
    """The launch-time width check takes widths off multiples of 8 (36) and
    past one column pass (264) in the layouts they took before, and a width
    whose smallest staged or depth tile does not fit one block (4,096) in
    the column-blocked layout, which it takes forced at the narrower widths
    too (the kernels' layouts from the tests' mirror of them)."""
    monkeypatch.setattr(tiles, "smem_bytes", smem_layout)
    p = FM.check_mma_width("fused_mlp_bwd", 110, hidden, 2)
    assert p.tiles and not p.blocked
    assert FM.check_mma_width("fused_mlp_bwd", 110, 4096, 2) == (False, [64, 32, 16], False,
                                                                 True)
    assert FM.check_mma_width("fused_mlp_bwd", 110, hidden, 2, blocked=True) == (
        p.chunked, p.tiles, False, True)


def test_folded_kink_rows_flag_a_pre_activation_on_the_kink():
    """``relu_kink_rows_folded`` flags a row whose layer-0 pre-activation
    is put on the relu kink, and a zero advantage removes a row's
    contribution to every trunk gradient (how the K3 checks use it)."""
    d_in, hidden, rows = 37, 64, 40
    ws = [w / np.sqrt(w.shape[0]) for w in _mats([(d_in, hidden), (hidden, hidden)], seed=8)]
    us = _mats([(hidden,), (hidden,)], seed=9)
    x = _mats([(rows, d_in)], seed=10)[0]
    mu, inv = FM.ln_stats(x)
    acc = FP._mm((x - mu) * inv, ws[0], True)  # layer 0's accumulator
    us[0][5] = -FM.bf16_round(acc[3, 5])
    kp = [ws[0], us[0], ws[1], us[1]]
    near = FP.relu_kink_rows_folded(x, kp, 2, True)
    assert near[3] and not near.all()
    aux = FP.pack_actor_aux(0.5 * x[:, :2], -2.0 + 0.1 * x[:, 2:3], torch.zeros(rows, 1))
    head = _mats([(hidden, 2), (2,)], seed=11)
    kg, *_ = FP.actor_grads_plain(x, aux, kp, head[0], head[1], torch.zeros(2), n_layers=2,
                                  use_fn=True, use_relu=True, bf16=True, clip_param=0.2)
    assert not any(t.any() for t in kg)


def test_critic_kink_rows_get_no_cotangent():
    """The bf16 K4 checks give rows next to a relu kink valid = 0, which
    zeros their value loss and every gradient they feed."""
    d_in, hidden, rows = 44, 64, 30
    ws = [w / np.sqrt(w.shape[0]) for w in _mats([(d_in, hidden), (hidden, hidden)], seed=15)]
    us = _mats([(hidden,), (hidden,)], seed=16)
    x = _mats([(rows, d_in)], seed=17)[0]
    vpred = _mats([(rows, 1)], seed=18)[0]
    aux = FP.pack_critic_aux(vpred, vpred + 3.0)
    aux[:, 2] = 0.0
    wv, bv = _mats([(hidden, 1), (1,)], seed=19)
    kg, dwv, dbv, met = FP.critic_grads_plain(
        x, aux, torch.tensor([0.5, 2.0]), [ws[0], us[0], ws[1], us[1]], wv, bv, n_layers=2,
        use_fn=True, use_relu=True, bf16=True, clip_param=0.2, huber_delta=10.0,
        use_huber=True, use_clipped=True)
    assert not any(t.any() for t in [*kg, dwv, dbv, met])


def test_unfolded_kink_rows_flag_a_pre_activation_within_a_bf16_step():
    """``relu_kink_rows`` in bf16 flags a row whose pre-activation sits one
    bf16 step from the kink (not within 1e-5 of it, so the f32 rule misses
    it): the tensor cores' summation order can move it across."""
    d_in, hidden, rows = 37, 64, 40
    params = _unfolded_params(d_in, hidden, 2, seed=20)
    x = _mats([(rows, d_in)], seed=21)[0]
    mu, inv = FM.ln_stats(x)
    a0 = FM.bf16_round((x - mu) * inv * params[0] + params[1])
    acc = FM.bf16_round(a0) @ FM.bf16_round(params[2])  # layer 0's accumulator
    step = torch.exp2(torch.floor(torch.log2(acc[3, 5].abs())) - 7)
    params[3][5] = -FM.bf16_round(acc[3, 5]) + step
    near = FM.relu_kink_rows(x, params, 2, True, bf16=True)
    assert near[3] and not near.all()
    assert not FM.relu_kink_rows(x, params, 2, True, bf16=False)[3]


@pytest.mark.parametrize("tiles,mma,want", [(1, True, 1), (150, True, 150), (264, True, 264),
                                            (265, True, 132), (38400, True, 132),
                                            (150, False, 132), (75, False, 75)])
def test_grads_blocks(tiles, mma, want):
    """The block count of K3, K4 and K2b on a 132-SM card: one block per
    tile up to two waves of tensor-core tiles (K3's and K2b's 9,600-row
    actor sets: 150 tiles of 64 rows; K4's 2,400 rows: 150 tiles of 16),
    then one per SM, looping."""
    assert FM.grads_blocks(tiles, 132, mma) == want


# shared memory in floats per tile of a kernel that fits 64-row tiles at
# d_in 110 and only 32- or 16-row tiles at 440 (as K4 and K2b)
def _fits_to_32_at_440(d_in):
    return lambda br: br * (1500 if d_in > 256 else 800)


@pytest.mark.parametrize("rows,d_in,sizes,want", [
    (2400, 440, (32, 16), 16),        # K4, 16 envs: 150 tiles of 16, not 75 of 32
    (614400, 440, (32, 16), 32),      # K4, 4,096 envs
    (1, 440, (32, 16), 16),
    (9600, 110, (64, 32, 16), 64),    # K2b actor, 16 envs: 150 tiles
    (9600, 440, (64, 32, 16), 32),    # K2b critic, 16 envs: 64 rows do not fit
    (2457600, 110, (64, 32, 16), 64),
    (3000, 110, (64, 32, 16), 16),
    (9600, 110, (64, 32), 64),        # K3, 16 envs
    (1000, 110, (64, 32), 32),
])
def test_mma_tile_rows(rows, d_in, sizes, want):
    """The row tile of a tensor-core gradient kernel on a 132-SM card: the
    largest that fits and still gives every SM a tile, else the smallest."""
    assert FM.mma_tile_rows(rows, d_in, _fits_to_32_at_440(d_in), 132, sizes) == want


def test_mma_tile_rows_refuses_a_row_that_fits_no_tile():
    with pytest.raises(ValueError, match="shared-memory budget"):
        FM.mma_tile_rows(100, 9000, lambda br: br * 9000, 132, (32, 16))


def _unfolded_params(d_in, hidden, n_layers, seed, use_fn=True):
    """The flat trunk list, Dense kernels scaled by 1/sqrt(d), every bias and
    LN affine moved off its init value."""
    rng = np.random.default_rng(seed)
    vec = lambda n, c: torch.from_numpy((c + 0.1 * rng.normal(size=n)).astype(np.float32))
    params = [vec(d_in, 1.0), vec(d_in, 0.0)] if use_fn else []
    d = d_in
    for _ in range(n_layers):
        w = torch.from_numpy((rng.normal(size=(d, hidden)) / np.sqrt(d)).astype(np.float32))
        params += [w, vec(hidden, 0.0), vec(hidden, 1.0), vec(hidden, 0.0)]
        d = hidden
    return params


def _ln_stats_real(r, h):
    """LN statistics over the first h columns; xhat over those, 0 beyond."""
    real = r[:, :h]
    mu = real.mean(dim=1, keepdim=True)
    inv = torch.rsqrt(torch.clamp((real * real).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
                      + FM.EPS)
    xhat = torch.zeros_like(r)
    xhat[:, :h] = (real - mu) * inv
    return xhat, inv


def _ln_bwd_real(g, xhat, inv, scale, h):
    """``_ln_bwd`` with the row means over the first h columns only."""
    gg = g * scale
    s1 = gg[:, :h].sum(dim=1, keepdim=True) / h
    s2 = (gg * xhat)[:, :h].sum(dim=1, keepdim=True) / h
    return inv * (gg - s1 - xhat * s2), (g * xhat).sum(dim=0), g.sum(dim=0)


def _bwd_chain(x, params, g, n_layers, use_fn, pad):
    """bf16 K2b with f64 products: the unfolded forward, then the backward of
    ``trunk_backward_plain``; when ``pad``, on the tensor-core kernel's
    operands: bf16 weights from ``pack_mma_weights``, every bias and LN
    affine zero-padded to pad16(H), the padded columns of every LN output
    and cotangent 0, layer 0's g W^T over pad16(d_in) columns in passes of
    at most 256 whose padded columns are dropped before the feature norm's
    backward. Returns (dx in x's dtype, f32 gradients)."""
    rnd, P = FM.bf16_round, torch.nn.functional.pad
    mm = lambda p, q: (rnd(p).double() @ rnd(q).double()).float()
    d_in, first = x.shape[1], 2 if use_fn else 0
    hidden = params[first].shape[1]
    hp = FM.pad16(hidden) if pad else hidden
    ws = [params[first + 4 * li] for li in range(n_layers)]
    if pad:
        buf, offs = FM.pack_mma_weights(ws, "cpu")
        ws = [buf[o : o + FM.pad16(w.shape[0]) * hp].view(FM.pad16(w.shape[0]), hp).float()
              for w, o in zip(ws, offs)]
    vecs = [[P(params[first + 4 * li + k], (0, hp - hidden)) for k in (1, 2, 3)]
            for li in range(n_layers)]
    a = x.float()
    if use_fn:
        xh0, inv0 = _ln_stats_real(a, d_in)
        a = rnd(xh0 * params[0] + params[1])
    a = P(a, (0, ws[0].shape[0] - d_in))
    cache = []
    for w, (b, s, c) in zip(ws, vecs):
        r = torch.relu(rnd(rnd(mm(a, w)) + rnd(b)))
        xhat, inv = _ln_stats_real(r, hidden)
        cache.append((a, r, xhat, inv))
        a = rnd(xhat * s + c)
    g = P(g.float(), (0, hp - hidden))
    grads = [None] * len(params)
    for li in reversed(range(n_layers)):
        a, r, xhat, inv = cache[li]
        o = first + 4 * li
        g, ds, dc = _ln_bwd_real(g, xhat, inv, vecs[li][1], hidden)
        g = g * (r > 0).float()
        d = d_in if li == 0 else hidden
        grads[o : o + 4] = [mm(a.t(), g)[:d, :hidden], g.sum(dim=0)[:hidden], ds[:hidden],
                            dc[:hidden]]
        w = ws[li]
        g = torch.cat([mm(g, w[c0 : c0 + 256].t()) for c0 in range(0, w.shape[0], 256)], dim=1)
    g = g[:, :d_in]
    if use_fn:
        g, grads[0], grads[1] = _ln_bwd_real(g, xh0, inv0, params[0], d_in)
    return g.to(x.dtype), grads


@pytest.mark.parametrize("d_in,hidden,n_layers,use_fn", [(110, 256, 2, True),
                                                         (440, 256, 2, True),
                                                         (37, 72, 3, True),
                                                         (45, 40, 1, False)])
def test_padded_backward_chain_equals_unpadded(d_in, hidden, n_layers, use_fn):
    """The padded bf16 backward, as the tensor-core K2b runs it, equals the
    unpadded one bit for bit: zero-padded LN scales and biases keep the
    padded cotangent columns 0, the two column passes of layer 0's g W^T at
    448 columns (d_in 440) join without a seam, and d(x)'s padded columns
    are dropped. The unpadded chain is ``trunk_backward_plain`` up to f32
    summation order (its products in f32)."""
    params = _unfolded_params(d_in, hidden, n_layers, seed=22, use_fn=use_fn)
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(29, d_in)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(29, hidden)).astype(np.float32))
    g[FM.relu_kink_rows(x, params, n_layers, use_fn, bf16=True)] = 0.0
    g = FM.bf16_round(g)
    want_dx, want = _bwd_chain(x, params, g, n_layers, use_fn, pad=False)
    got_dx, got = _bwd_chain(x, params, g, n_layers, use_fn, pad=True)
    assert torch.equal(got_dx, want_dx)
    for a, b, p in zip(got, want, params):
        assert a.shape == p.shape and torch.equal(a, b)
    plain_dx, plain = FM.trunk_backward_plain(x, params, g, n_layers, use_fn, True, True)
    for a, b in zip([want_dx.float(), *want], [plain_dx.float(), *plain]):
        assert float((a - b).norm() / b.norm()) < 1e-4
