"""The CPU side of the bf16 tensor-core kernels (K2 forward, K3 actor): the
padded bf16 weight copies, the padding algebra the kernels rely on, the
per-version cache of ``MLPBase.packed_params``, K3's packing, and the relu
kink rule of K3's checks.

The kernels read each weight as a bf16 copy zero-padded to multiples of 16
in both dimensions, feed zero-padded activation columns, take LayerNorm
statistics over the real width only and write the padded columns of every
LN output as 0. The padded chain below does exactly that in PyTorch, with
the products in float64, where the sums of bf16 x bf16 products are exact;
it must equal the unpadded chain bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from dcc_tpu_torch.models import MLPBase
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP


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


@pytest.mark.parametrize("hidden", [36, 264])
def test_mma_width_check(hidden):
    with pytest.raises(ValueError, match="multiple of 8"):
        FM.check_mma_width(hidden)


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


@pytest.mark.parametrize("tiles,mma,want", [(1, True, 1), (150, True, 150), (264, True, 264),
                                            (265, True, 132), (38400, True, 132),
                                            (150, False, 132), (75, False, 75)])
def test_grads_blocks(tiles, mma, want):
    """K3's block count on a 132-SM card: the 9,600-row main path (150
    tiles of 64 rows) gets one block per tile; large batches loop."""
    assert FP.grads_blocks(tiles, 132, mma) == want
