"""The CUDA kernels K1-K4, K2b and the unfolded K3u / K4u (and, at rows too
wide to stage, the chunked K2, K2b, K3, K4, K3u and K4u, the dV0 kernel and
the layer-0 input backward) against their plain PyTorch versions, on the
card.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture, which
skips when no CUDA device is present (the kernels have no CPU mode), so on a
CPU-only host the whole file skips. On a machine with a card, without JAX
installed (``--noconftest`` skips ``tests/conftest.py``, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The shapes are small but ragged (row counts that are not a multiple of the
row tile) and cover the options the default model does not use: tanh, no
feature norm, one and three layers, other widths, bf16 input rows. In bf16
K2, K2b, K3 and K4 run on the tensor cores (``*_mma`` entry points), which
pad every width to a multiple of 16 and tile rows by 16, 32 or 64; their
row counts around those tiles and their padded widths have tests of their
own. The tolerances are those of ``chip_smoke.py``: f32 differs by
summation order, bf16 by 1-ulp flips of the bf16 roundings inside the
chain. Rows next to a relu kink, where two summation orders may take
opposite sides, get a zero cotangent (K2b, ``relu_kink_rows``) or a zero
advantage / valid flag (bf16 K3 / K4, ``relu_kink_rows_folded``; K3u / K4u,
whose chain is K2b's, ``relu_kink_rows``). Each bf16 check of K3u / K4u
also requires the kernel computed in f32 to land outside the bf16 bound.
A row whose features round one bf16 step apart in K4u's summation order
(the LN statistics, the tensor cores' accumulation) can round its value to
the neighbouring bf16 number, which moves its value cotangent by that step;
the value head's bias gradient, one number that sums those cotangents, can
cancel to about one row's. So the bf16 K4u checks first probe the kernel
for the rows whose value is not the plain version's (``_value_flip_rows``:
0.2-0.8 % of the rows at 333 to 20,000 rows on the H100), require each to
owe it to features within one bf16 step of the plain version's, and give
those rows valid = 0; then every tensor is held to the bf16 bound.

Trunks past 8 layers: each bf16 gradient kernel's depth layout bit for bit
against its staged layout, and every kernel against its plain version at 8
and 9 layers on trunks whose biases are drawn from N(0, 1) (ROADMAP C8).

This module imports no JAX: the JAX comparison of the plain versions is in
the other ``tests/test_torch_*.py`` files.
"""

import math

import pytest
import torch

from dcc_tpu_torch.ops import cuda_build as cb
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops.cuda_gae import compute_gae_cuda, gae_columns_cuda, gae_plan
from dcc_tpu_torch.ops.gae import compute_gae

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and bool(got.isfinite().all())
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _trunk_params(gen, d_in, hidden, n_layers, use_fn, dev):
    def rnd(*s, scale=1.0):
        return (scale * torch.randn(s, generator=gen)).to(dev)

    params = [1.0 + rnd(d_in, scale=0.1), rnd(d_in, scale=0.1)] if use_fn else []
    d = d_in
    for _ in range(n_layers):
        params += [rnd(d, hidden, scale=d ** -0.5), rnd(hidden, scale=0.1),
                   1.0 + rnd(hidden, scale=0.1), rnd(hidden, scale=0.1)]
        d = hidden
    return params


def _segment_starts(T, S, L):
    """First steps of K1's segments inside (0, T): rounds of S * L steps from
    the end of time, S segments of L steps from each round's start."""
    return sorted({max(t1 - S * L, 0) + s * L for t1 in range(T, 0, -S * L)
                   for s in range(S)} & set(range(1, T)))


def _gae_inputs(T, E, seed, dev, plan=None):
    """(T, E, 1) rewards, (T + 1, E, 1) values and masks; the masks hold
    random episode ends and zero runs across every segment and round
    boundary of K1's plan (``plan``, by default ``gae_plan``'s (S, L)) in
    every third column."""
    gen = torch.Generator().manual_seed(seed)
    r = torch.randn(T, E, 1, generator=gen)
    v = torch.randn(T + 1, E, 1, generator=gen)
    m = (torch.rand(T + 1, E, 1, generator=gen) > 0.05).float()
    S, L = plan or gae_plan(T, E)[1:3]
    for start in _segment_starts(T, S, L):
        m[max(start - 1, 1):start + 2, ::3] = 0.0
    return r.to(dev), v.to(dev), m.to(dev)


def _assert_gae_close(adv, ret, want_adv, want_ret):
    # f32 with FMA contraction and re-associated segment boundaries: a few
    # ulps of the running sum (chip_smoke.py's bound)
    tol = 1e-5 * (float(want_adv.abs().max()) + 1.0)
    for got, want in ((adv, want_adv), (ret, want_ret)):
        assert _rel(got, want) < 1e-5 and float((got - want).abs().max()) <= tol


# the last three walk time in two rounds under gae_plan (T > S * L)
GAE_SHAPES = [(150, 16), (150, 16384), (1, 16), (5, 3), (151, 17), (150, 16387),
              (1000, 64), (2000, 16), (600, 16387)]


@pytest.mark.parametrize("T,E", GAE_SHAPES)
def test_gae_kernel_matches_plain(cuda, T, E):
    r, v, m = _gae_inputs(T, E, T + E, cuda)
    cb.reset_launches()
    adv, ret = compute_gae_cuda(r, v, m, 0.99, 0.95)
    assert cb.LAUNCHES["gae"] == 1 and cb.ENTRY["gae"] == "dcc_gae_seg"
    _assert_gae_close(adv, ret, *compute_gae(r, v, m, 0.99, 0.95))


@pytest.mark.parametrize("S,L", [(1, 32), (3, 7), (32, 1)])
def test_gae_kernel_other_plans(cuda, S, L):
    # the C entry called directly with plans gae_plan does not pick at
    # T = 150, each in several rounds: one 32-step segment, three 7-step
    # segments, 32 one-step segments
    T, B = 150, 37
    r, v, m = (x[..., 0] for x in _gae_inputs(T, B, S * L, cuda, (S, L)))
    adv, ret = torch.empty_like(r), torch.empty_like(r)
    code = cb.library("gae").dcc_gae_seg(
        r.data_ptr(), v.data_ptr(), m.data_ptr(), adv.data_ptr(), ret.data_ptr(),
        T, B, 32, S, L, 0.99, 0.99 * 0.95, cb.stream_of(r))
    cb.check("gae", code, "gae")
    _assert_gae_close(adv, ret, *compute_gae(r, v, m, 0.99, 0.95))


def test_gae_kernel_broadcast_values(cuda):
    # values shared by every column: the wrapper broadcasts before the launch
    r, v, m = _gae_inputs(12, 32, 8, cuda)
    r, m = r.reshape(12, 8, 4, 1), m.reshape(13, 8, 4, 1)
    v = v[:, :1, :].reshape(13, 1, 1, 1)
    adv, ret = compute_gae_cuda(r, v, m, 0.99, 0.95)
    want_adv, want_ret = compute_gae(r, v, m, 0.99, 0.95)
    assert adv.shape == (12, 8, 4, 1)
    assert _rel(adv, want_adv) < 1e-5 and _rel(ret, want_ret) < 1e-5


@pytest.mark.parametrize("E,A", [(4, 4), (16, 4)], ids=["e-eq-a", "e16-a4"])
def test_gae_kernel_separated_layout(cuda, E, A):
    # separated policies: per-env rewards and masks (T, E, 1, 1) against
    # per-agent values (T+1, E, A, 1); at E == A a missing agent axis would
    # pair the masks' env axis with the values' agent axis
    r, _, m = _gae_inputs(150, E, 9, cuda)
    v = torch.randn(151, E, A, 1, generator=torch.Generator().manual_seed(10)).to(cuda)
    r, m = r[:, :, None], m[:, :, None]
    adv, ret = compute_gae_cuda(r, v, m, 0.99, 0.95)
    want_adv, want_ret = compute_gae(r, v, m, 0.99, 0.95)
    assert adv.shape == ret.shape == (150, E, A, 1)
    assert _rel(adv, want_adv) < 1e-5 and _rel(ret, want_ret) < 1e-5


@pytest.mark.parametrize("T", [150, 600])
def test_gae_kernel_is_deterministic(cuda, T):
    r, v, m = _gae_inputs(T, 16387, 5, cuda)
    first = compute_gae_cuda(r, v, m, 0.99, 0.95)
    second = compute_gae_cuda(r, v, m, 0.99, 0.95)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_gae_kernel_one_launch_per_call(cuda):
    r, v, m = _gae_inputs(150, 16, 6, cuda)
    cb.reset_launches()
    for calls in (1, 2, 3):
        gae_columns_cuda(r[..., 0], v[..., 0], m[..., 0], 0.99, 0.95)
        assert dict(cb.LAUNCHES) == {"gae": calls} and cb.ENTRY == {"gae": "dcc_gae_seg"}


def test_gae_kernel_refuses_bad_operands(cuda):
    r, v, m = (x[..., 0] for x in _gae_inputs(12, 8, 7, cuda))
    with pytest.raises(ValueError, match="values has shape"):
        gae_columns_cuda(r, v[1:], m, 0.99, 0.95)  # (T, B): the slice the old wrapper took
    with pytest.raises(ValueError, match="masks has shape"):
        gae_columns_cuda(r, v, m[:, :-1], 0.99, 0.95)
    with pytest.raises(ValueError, match="dtype"):
        gae_columns_cuda(r, v.double(), m, 0.99, 0.95)
    with pytest.raises(ValueError, match="contiguous"):
        gae_columns_cuda(r, v, m.t().contiguous().t(), 0.99, 0.95)


@pytest.mark.parametrize(
    "rows,d_in,hidden,n_layers,use_fn,use_relu",
    [(1, 110, 256, 2, True, True), (70, 440, 256, 2, True, True),
     (33, 37, 64, 1, False, False), (45, 110, 128, 3, True, False)],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_trunk_forward_kernel_matches_plain(cuda, rows, d_in, hidden, n_layers, use_fn,
                                            use_relu, bf16):
    gen = torch.Generator().manual_seed(rows)
    params = _trunk_params(gen, d_in, hidden, n_layers, use_fn, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    if bf16:
        x = x.bfloat16()  # the kernel takes bf16 rows as well
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=bf16)
    got = FM.trunk_forward_cuda(x, params, **kw)
    want = FM.trunk_forward_plain(x, params, **kw)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert _rel(got, want) < (2e-3 if bf16 else 1e-5)


def _cotangent(gen, x, params, hidden, n_layers, use_fn, use_relu, bf16):
    """A random cotangent of the trunk output, zero on the rows next to a
    relu kink (``relu_kink_rows``), in the output's dtype."""
    g = torch.randn(x.shape[0], hidden, generator=gen).to(x.device)
    if use_relu:
        g[FM.relu_kink_rows(x, params, n_layers, use_fn, bf16)] = 0.0
    return g.bfloat16() if bf16 else g


@pytest.mark.parametrize(
    "rows,d_in,hidden,n_layers,use_fn,use_relu",
    [(1, 110, 256, 2, True, True), (333, 110, 256, 2, True, True),
     (70, 440, 256, 2, True, True), (33, 37, 64, 1, False, False),
     (45, 110, 128, 3, True, False)],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_trunk_backward_kernel_matches_plain(cuda, rows, d_in, hidden, n_layers, use_fn,
                                             use_relu, bf16):
    gen = torch.Generator().manual_seed(rows + d_in)
    params = _trunk_params(gen, d_in, hidden, n_layers, use_fn, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    if bf16:
        x = x.bfloat16()  # the stored observations of the bf16 update
    g = _cotangent(gen, x, params, hidden, n_layers, use_fn, use_relu, bf16)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=bf16)
    cb.reset_launches()
    dx, grads = FM.trunk_backward_cuda(x, params, g, **kw)
    assert cb.LAUNCHES["fused_mlp_bwd"] == 1
    want_dx, want = FM.trunk_backward_plain(x, params, g, **kw)
    assert dx.dtype == x.dtype
    for got, ref in zip([dx, *grads], [want_dx, *want]):
        assert _rel(got, ref) < (4e-3 if bf16 else 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_trunk_autograd_launches_both_kernels(cuda, bf16):
    """fused_mlp under autograd: K2 forward and K2b backward on the card,
    the gradients of the plain versions on the CPU."""
    gen = torch.Generator().manual_seed(7)
    cpu = _trunk_params(gen, 110, 64, 2, True, "cpu")
    x = torch.randn(50, 110, generator=gen)
    g = _cotangent(gen, x, cpu, 64, 2, True, True, bf16).float()
    grads = {}
    for dev in ("cpu", cuda):
        params = [p.detach().to(dev).requires_grad_() for p in cpu]
        cb.reset_launches()
        out = FM.fused_mlp(x.to(dev), params, n_layers=2, bf16=bf16)
        (out.float() * g.to(dev)).sum().backward()
        grads[str(dev)] = [p.grad.cpu() for p in params]
        if dev == cuda:
            assert cb.LAUNCHES["fused_mlp"] == cb.LAUNCHES["fused_mlp_bwd"] == 1
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel(got, want) < (4e-3 if bf16 else 1e-4)


def _ppo_case(gen, kind, rows, d_in, hidden, n_layers, use_fn, dev):
    params = _trunk_params(gen, d_in, hidden, n_layers, use_fn, dev)
    n_out = 2 if kind == "actor" else 1
    head_w = (0.1 * torch.randn(hidden, n_out, generator=gen)).to(dev)
    head_b = (0.1 * torch.randn(n_out, generator=gen)).to(dev)
    kp, hw, hb = FP.fold_trunk(params, head_w, head_b, n_layers, use_fn)
    x = torch.randn(rows, d_in, generator=gen).to(dev)
    if kind == "actor":
        aux = FP.pack_actor_aux(
            (0.5 * torch.randn(rows, 2, generator=gen)).to(dev),
            (-2.0 + 0.3 * torch.randn(rows, 1, generator=gen)).to(dev),
            torch.randn(rows, 1, generator=gen).to(dev),
        )
    else:
        vpred = torch.randn(rows, 1, generator=gen)
        ret = vpred + 3.0 * torch.randn(rows, 1, generator=gen)
        aux = FP.pack_critic_aux(vpred.to(dev), ret.to(dev))
    return x, aux, kp, hw, hb


def _flat(out):
    return [*out[0], *out[1:]]


@pytest.mark.parametrize(
    "rows,d_in,hidden,n_layers,use_fn,use_relu",
    [(1, 110, 256, 2, True, True), (1000, 110, 256, 2, True, True),
     (77, 37, 64, 1, False, False), (45, 110, 256, 3, True, True)],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_actor_grads_kernel_matches_plain(cuda, rows, d_in, hidden, n_layers, use_fn,
                                          use_relu, bf16):
    gen = torch.Generator().manual_seed(rows + d_in)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", rows, d_in, hidden, n_layers, use_fn,
                                   cuda)
    log_std = torch.tensor([-0.3, 0.2], device=cuda)
    if bf16:
        x = x.bfloat16()
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=bf16,
              clip_param=0.2)
    cb.reset_launches()
    got = FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std, **kw)
    assert cb.LAUNCHES["actor_ppo_grads"] == 1
    want = FP.actor_grads_plain(x, aux, kp, hw, hb, log_std, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < (4e-3 if bf16 else 1e-3)


@pytest.mark.parametrize(
    "rows,n_layers,use_fn,use_relu,use_huber,use_clipped",
    [(1, 2, True, True, True, True), (333, 2, True, True, True, True),
     (90, 1, False, False, False, True), (64, 3, True, True, True, False)],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_critic_grads_kernel_matches_plain(cuda, rows, n_layers, use_fn, use_relu,
                                           use_huber, use_clipped, bf16):
    gen = torch.Generator().manual_seed(rows + n_layers)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", rows, 440, 128, n_layers, use_fn, cuda)
    if bf16:
        x = x.bfloat16()
        if use_relu:  # the tensor cores' summation order near a relu kink
            aux[FP.relu_kink_rows_folded(x, kp, n_layers, use_fn), 2] = 0.0
    norm = torch.tensor([0.5, 2.0], device=cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=bf16,
              clip_param=0.2, huber_delta=10.0, use_huber=use_huber,
              use_clipped=use_clipped)
    cb.reset_launches()
    got = FP.critic_grads_cuda(x, aux, norm, kp, hw, hb, **kw)
    assert cb.LAUNCHES["critic_ppo_grads"] == 1
    want = FP.critic_grads_plain(x, aux, norm, kp, hw, hb, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < (4e-3 if bf16 else 1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    params = _trunk_params(gen, 16, 32, 1, True, cuda)
    with pytest.raises(ValueError, match="dtype"):
        FM.trunk_forward_cuda(torch.zeros(4, 16, dtype=torch.float64, device=cuda), params,
                              n_layers=1)
    with pytest.raises(ValueError, match="contiguous"):
        FM.trunk_forward_cuda(torch.zeros(16, 4, device=cuda).t(), params, n_layers=1)
    with pytest.raises(ValueError, match="CUDA"):
        FM.trunk_forward_cuda(torch.zeros(4, 16), params, n_layers=1)
    trainable = [p.clone().requires_grad_() for p in params]
    with pytest.raises(RuntimeError, match="fused_mlp"):
        FM.trunk_forward_cuda(torch.zeros(4, 16, device=cuda), trainable, n_layers=1)
    with pytest.raises(ValueError, match="shape"):
        FM.trunk_backward_cuda(torch.zeros(4, 16, device=cuda), params,
                               torch.zeros(4, 31, device=cuda), n_layers=1)
    # parameters that do not fit the row width would be read out of bounds
    with pytest.raises(ValueError, match="shapes"):
        FM.trunk_forward_cuda(torch.zeros(4, 17, device=cuda), params, n_layers=1)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", 8, 16, 32, 1, True, cuda)
    with pytest.raises(ValueError, match="shapes"):
        FP.actor_grads_cuda(x[:, :15].contiguous(), aux, kp, hw, hb,
                            torch.zeros(2, device=cuda), n_layers=1, use_fn=True,
                            use_relu=True, bf16=False, clip_param=0.2)


_RAGGED = [1, 15, 17, 63, 65, 1000]


@pytest.mark.parametrize("rows", _RAGGED)
@pytest.mark.parametrize("d_in,hidden,use_relu", [(110, 256, True), (440, 256, True),
                                                  (37, 64, False)])
def test_bf16_trunk_forward_on_tensor_cores(cuda, rows, d_in, hidden, use_relu):
    """bf16 K2 on row counts around its tiles and widths it pads (110 -> 112,
    440 -> 448, 37 -> 48), through the tensor-core entry point."""
    gen = torch.Generator().manual_seed(rows + d_in)
    params = _trunk_params(gen, d_in, hidden, 2, True, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=use_relu, bf16=True)
    cb.reset_launches()
    got = FM.trunk_forward_cuda(x, params, **kw)
    assert cb.LAUNCHES["fused_mlp"] == 1 and cb.ENTRY["fused_mlp"] == "dcc_trunk_fwd_mma"
    assert _rel(got, FM.trunk_forward_plain(x, params, **kw)) < 2e-3


@pytest.mark.parametrize("rows", _RAGGED + [20000])
@pytest.mark.parametrize("d_in,hidden,n_layers,use_relu", [(110, 256, 2, True),
                                                           (37, 64, 2, False)])
def test_bf16_actor_grads_on_tensor_cores(cuda, rows, d_in, hidden, n_layers, use_relu):
    """bf16 K3 on row counts around its tiles (20000 rows: several tiles per
    block) and padded widths, through the tensor-core entry point; rows past
    the last are masked, not padded. Rows next to a relu kink get a zero
    advantage (``relu_kink_rows_folded``): there the tensor cores' summation
    order and the plain version's may take opposite sides."""
    gen = torch.Generator().manual_seed(rows + d_in + 1)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", rows, d_in, hidden, n_layers, True, cuda)
    log_std = torch.tensor([-0.3, 0.2], device=cuda)
    x = x.bfloat16()
    if use_relu:
        aux[FP.relu_kink_rows_folded(x, kp, n_layers, True), 3] = 0.0
    kw = dict(n_layers=n_layers, use_fn=True, use_relu=use_relu, bf16=True, clip_param=0.2)
    cb.reset_launches()
    got = FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std, **kw)
    assert cb.ENTRY["actor_ppo_grads"] == "dcc_actor_grads_mma"
    want = FP.actor_grads_plain(x, aux, kp, hw, hb, log_std, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < 4e-3


@pytest.mark.parametrize("rows", _RAGGED + [20000])
@pytest.mark.parametrize("d_in,hidden,n_layers,use_relu", [(440, 256, 2, True),
                                                           (110, 256, 2, True),
                                                           (37, 64, 2, False)])
def test_bf16_critic_grads_on_tensor_cores(cuda, rows, d_in, hidden, n_layers, use_relu):
    """bf16 K4 on row counts around its 16- and 32-row tiles (20000 rows:
    several tiles per block) and padded widths (440 -> 448), through the
    tensor-core entry point. Rows next to a relu kink get valid = 0
    (``relu_kink_rows_folded``), which zeros their value-loss cotangent."""
    gen = torch.Generator().manual_seed(rows + d_in + 2)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", rows, d_in, hidden, n_layers, True, cuda)
    x = x.bfloat16()
    if use_relu:
        aux[FP.relu_kink_rows_folded(x, kp, n_layers, True), 2] = 0.0
    norm = torch.tensor([0.5, 2.0], device=cuda)
    kw = dict(n_layers=n_layers, use_fn=True, use_relu=use_relu, bf16=True, clip_param=0.2,
              huber_delta=10.0, use_huber=True, use_clipped=True)
    cb.reset_launches()
    got = FP.critic_grads_cuda(x, aux, norm, kp, hw, hb, **kw)
    assert cb.LAUNCHES["critic_ppo_grads"] == 1
    assert cb.ENTRY["critic_ppo_grads"] == "dcc_critic_grads_mma"
    want = FP.critic_grads_plain(x, aux, norm, kp, hw, hb, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < 4e-3


@pytest.mark.parametrize("rows", _RAGGED + [20000])
@pytest.mark.parametrize("d_in,hidden,n_layers,use_fn,use_relu", [
    (110, 256, 2, True, True), (440, 256, 2, True, True), (37, 64, 2, True, False),
    (45, 72, 1, False, True)])
def test_bf16_trunk_backward_on_tensor_cores(cuda, rows, d_in, hidden, n_layers, use_fn,
                                             use_relu):
    """bf16 K2b on row counts around its 16-, 32- and 64-row tiles (20000
    rows: several tiles per block) and padded widths (110 -> 112, 440 -> 448
    in two column passes of layer 0's g W^T), through the tensor-core entry
    point, with bf16 rows as the update stores them. Rows next to a relu
    kink get a zero cotangent (``relu_kink_rows`` with its bf16 rule)."""
    gen = torch.Generator().manual_seed(rows + d_in + 3)
    params = _trunk_params(gen, d_in, hidden, n_layers, use_fn, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda).bfloat16()
    g = _cotangent(gen, x, params, hidden, n_layers, use_fn, use_relu, True)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True)
    cb.reset_launches()
    dx, grads = FM.trunk_backward_cuda(x, params, g, **kw)
    assert cb.LAUNCHES["fused_mlp_bwd"] == 1
    assert cb.ENTRY["fused_mlp_bwd"] == "dcc_trunk_bwd_mma"
    want_dx, want = FM.trunk_backward_plain(x, params, g, **kw)
    assert dx.dtype == x.dtype
    for got, ref in zip([dx, *grads], [want_dx, *want]):
        assert _rel(got, ref) < 4e-3


def test_f32_kernels_stay_on_fma(cuda):
    """f32 K2, K2b, K3 and K4 go through the FMA entry points (full f32, no
    TF32)."""
    gen = torch.Generator().manual_seed(3)
    cb.reset_launches()
    params = _trunk_params(gen, 110, 64, 2, True, cuda)
    x = torch.randn(20, 110, generator=gen).to(cuda)
    FM.trunk_forward_cuda(x, params, n_layers=2)
    FM.trunk_backward_cuda(x, params, torch.randn(20, 64, generator=gen).to(cuda), n_layers=2)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", 20, 110, 64, 2, True, cuda)
    FP.actor_grads_cuda(x, aux, kp, hw, hb, torch.zeros(2, device=cuda), n_layers=2,
                        use_fn=True, use_relu=True, bf16=False, clip_param=0.2)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", 20, 440, 64, 2, True, cuda)
    FP.critic_grads_cuda(x, aux, torch.tensor([0.5, 2.0], device=cuda), kp, hw, hb,
                         n_layers=2, use_fn=True, use_relu=True, bf16=False, clip_param=0.2,
                         huber_delta=10.0, use_huber=True, use_clipped=True)
    assert cb.ENTRY == {"fused_mlp": "dcc_trunk_fwd", "fused_mlp_bwd": "dcc_trunk_bwd",
                        "actor_ppo_grads": "dcc_actor_grads",
                        "critic_ppo_grads": "dcc_critic_grads"}


@pytest.mark.parametrize("hidden", [2048, 4096])
def test_bf16_kernels_refuse_widths_they_cannot_take(cuda, hidden):
    """A hidden width whose smallest row tile does not fit one block is
    refused at launch, naming ROADMAP B3 (K2, whose forward keeps no
    activation cache, still takes it)."""
    gen = torch.Generator().manual_seed(hidden)
    params = _trunk_params(gen, 16, hidden, 2, True, cuda)
    with pytest.raises(ValueError, match="ROADMAP B3"):
        FM.trunk_backward_cuda(torch.zeros(4, 16, device=cuda), params,
                               torch.zeros(4, hidden, device=cuda), n_layers=2, bf16=True)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", 8, 16, hidden, 2, True, cuda)
    with pytest.raises(ValueError, match="ROADMAP B3"):
        FP.actor_grads_cuda(x, aux, kp, hw, hb, torch.zeros(2, device=cuda), n_layers=2,
                            use_fn=True, use_relu=True, bf16=True, clip_param=0.2)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", 8, 16, hidden, 2, True, cuda)
    with pytest.raises(ValueError, match="ROADMAP B3"):
        FP.critic_grads_cuda(x, aux, torch.tensor([0.5, 2.0], device=cuda), kp, hw, hb,
                             n_layers=2, use_fn=True, use_relu=True, bf16=True, clip_param=0.2,
                             huber_delta=10.0, use_huber=True, use_clipped=True)


def _unfolded_case(gen, kind, rows, d_in, hidden, n_layers, use_fn, use_relu, bf16, dev):
    """K3u / K4u operands: the flat trunk list, the head, rows (bf16 in bf16
    mode) and aux; rows next to a relu kink of the unfolded chain
    (``relu_kink_rows``, with its bf16 rule) get a zero advantage / valid, as
    do, in bf16 on the card, the critic's rows whose value the kernel rounds
    apart from the plain version's (``_value_flip_rows``)."""
    params = _trunk_params(gen, d_in, hidden, n_layers, use_fn, dev)
    n_out = 2 if kind == "actor" else 1
    head_w = (0.1 * torch.randn(hidden, n_out, generator=gen)).to(dev)
    head_b = (0.1 * torch.randn(n_out, generator=gen)).to(dev)
    x = torch.randn(rows, d_in, generator=gen).to(dev)
    if bf16:
        x = x.bfloat16()
    if kind == "actor":
        aux = FP.pack_actor_aux(
            (0.5 * torch.randn(rows, 2, generator=gen)).to(dev),
            (-2.0 + 0.3 * torch.randn(rows, 1, generator=gen)).to(dev),
            torch.randn(rows, 1, generator=gen).to(dev),
        )
    else:
        vpred = torch.randn(rows, 1, generator=gen)
        ret = vpred + 3.0 * torch.randn(rows, 1, generator=gen)
        aux = FP.pack_critic_aux(vpred.to(dev), ret.to(dev))
    if use_relu:
        aux[FM.relu_kink_rows(x, params, n_layers, use_fn, bf16),
            2 if kind == "critic" else 3] = 0.0  # valid / advantage
    if bf16 and kind == "critic" and dev.type == "cuda":
        flips = _value_flip_rows(x, aux, params, head_w, head_b, n_layers, use_fn, use_relu)
        print(f"K4u bf16, {rows} x {d_in}: {len(flips)} values off; (value gap in bf16 steps, "
              f"feature gap in bf16 epsilons): {flips}")
        assert len(flips) <= 3 + rows // 20  # far above the 0.2-0.8 % measured
        aux[list(flips), 2] = 0.0
    return x, aux, params, head_w, head_b


def _bf16_step(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-40))) - 7)


def _value_flip_rows(x, aux, params, hw, hb, n_layers, use_fn, use_relu, masks=None) -> dict:
    """{row: (|kernel - plain| in bf16 steps of the plain value,
    ||kernel - plain features|| / ||plain features|| in units of bf16's
    epsilon 2^-7)} for the rows with valid != 0 whose value in bf16 K4u is
    not the plain version's.

    Found by probing the kernel: with the returns set to the plain values,
    the unclipped squared loss and valid = 2 / step^2, its loss sum over a
    set of rows is the sum of the rows' squared steps, exactly 0 where every
    value agrees; bisection narrows the sets to rows. Each row found must
    owe its value to its features: read back from the kernel alone (dwv
    with the row's cotangent -1, from a saturated one-sided Huber), they
    agree with the plain version's within bf16's epsilon in norm (an
    element can be several of its own steps off: where the LN bias cancels
    ``xhat * scale``, or where a step of an earlier rounding moves xhat),
    and the kernel's value (dbv of the unclipped squared loss against the
    plain value) is theirs through the head, up to one rounding step."""
    feat = FM._forward_chain(x, params, n_layers, use_fn, use_relu, True, masks)[0].float()
    v = FM.dense(feat, hw, hb, True)[:, 0]
    step = _bf16_step(v)
    norm = torch.tensor([0.0, 1.0], device=x.device)

    def launch(ret, valid, huber_delta=None):
        a = torch.stack([v, ret, valid], dim=1)
        return FP.critic_grads_unfolded_cuda(
            x, a, norm, params, hw, hb, n_layers=n_layers, use_fn=use_fn, use_relu=use_relu,
            bf16=True, clip_param=0.2, huber_delta=huber_delta or 1.0,
            use_huber=huber_delta is not None, use_clipped=False)

    def steps2(rows):
        valid = torch.zeros_like(v)
        valid[rows] = 2.0 / step[rows] ** 2
        return float(launch(v, valid)[-1][0])

    found, todo = {}, [torch.nonzero(aux[:, 2] != 0)[:, 0]]
    while todo:
        rows = todo.pop()
        s2 = steps2(rows) if len(rows) else 0.0
        if s2 == 0.0:
            continue
        if len(rows) == 1:
            found[int(rows[0])] = s2**0.5
        else:
            todo += [rows[: len(rows) // 2], rows[len(rows) // 2 :]]
    for r in found:
        one = torch.zeros_like(v)
        one[r] = 1.0
        v_k = v[r] + launch(v, one)[2][0]  # dbv = kernel value - plain value
        f_k = -launch(v + 100.0, one, huber_delta=1.0)[1][:, 0]  # dwv = -features
        gap = float((f_k - feat[r]).norm() / feat[r].norm()) * 2**7
        v_f = FM.dense(f_k[None], hw, hb, True)[0, 0]
        assert gap <= 1.0 and float((v_k - v_f).abs()) <= float(_bf16_step(v_k)), (r, gap)
        found[r] = (found[r], gap)
    return found


def _assert_unfolded_close(got, want, bf16):
    tol = 4e-3 if bf16 else 1e-3
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < tol


def _unfolded(kind, x, aux, params, hw, hb, on_card, **kw):
    if kind == "actor":
        fn = FP.actor_grads_unfolded_cuda if on_card else FP.actor_grads_unfolded_plain
        return fn(x, aux, params, hw, hb, torch.tensor([-0.3, 0.2], device=x.device), **kw)
    fn = FP.critic_grads_unfolded_cuda if on_card else FP.critic_grads_unfolded_plain
    return fn(x, aux, torch.tensor([0.5, 2.0], device=x.device), params, hw, hb,
              huber_delta=10.0, use_huber=True, use_clipped=True, **kw)


@pytest.mark.parametrize("kind", ["actor", "critic"])
@pytest.mark.parametrize(
    "rows,d_in,hidden,n_layers,use_fn,use_relu",
    [(1, 110, 256, 2, True, True), (1000, 110, 256, 2, True, True),
     (333, 440, 256, 2, True, True), (77, 37, 64, 1, False, False),
     (45, 110, 128, 3, True, True)],
)
@pytest.mark.parametrize("bf16", [False, True])
def test_unfolded_grads_kernel_matches_plain(cuda, kind, rows, d_in, hidden, n_layers, use_fn,
                                             use_relu, bf16):
    """K3u / K4u against their plain versions: f32 within 1e-3, bf16 within
    4e-3 (the kernel computed in f32 outside that bound), one launch through
    the unfolded entry point (``*_mma`` in bf16)."""
    gen = torch.Generator().manual_seed(rows + d_in + n_layers)
    x, aux, params, hw, hb = _unfolded_case(gen, kind, rows, d_in, hidden, n_layers, use_fn,
                                            use_relu, bf16, cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=bf16, clip_param=0.2)
    name = f"{kind}_ppo_grads_unfolded"
    cb.reset_launches()
    got = _unfolded(kind, x, aux, params, hw, hb, True, **kw)
    assert cb.LAUNCHES == {name: 1}
    assert cb.ENTRY[name] == f"dcc_{kind}_grads_unfolded" + ("_mma" if bf16 else "")
    want = _unfolded(kind, x, aux, params, hw, hb, False, **kw)
    assert [tuple(g.shape) for g in got[0]] == [tuple(p.shape) for p in params]
    _assert_unfolded_close(got, want, bf16)
    if bf16 and rows > 1:
        f32 = _unfolded(kind, x, aux, params, hw, hb, True, **{**kw, "bf16": False})
        assert max(_rel(g, w) for g, w in zip(_flat(f32), _flat(want))) > 4e-3


@pytest.mark.parametrize("kind", ["actor", "critic"])
@pytest.mark.parametrize("rows", _RAGGED + [20000])
def test_bf16_unfolded_grads_on_tensor_cores(cuda, kind, rows):
    """bf16 K3u / K4u at the main path's widths (actor 110, critic 440 ->
    448 in two column passes of layer 0's g W^T) on row counts around their
    tiles (20000 rows: several tiles per block)."""
    d_in = 110 if kind == "actor" else 440
    gen = torch.Generator().manual_seed(rows + d_in + 5)
    x, aux, params, hw, hb = _unfolded_case(gen, kind, rows, d_in, 256, 2, True, True, True,
                                            cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=True, clip_param=0.2)
    cb.reset_launches()
    got = _unfolded(kind, x, aux, params, hw, hb, True, **kw)
    assert cb.ENTRY[f"{kind}_ppo_grads_unfolded"] == f"dcc_{kind}_grads_unfolded_mma"
    want = _unfolded(kind, x, aux, params, hw, hb, False, **kw)
    _assert_unfolded_close(got, want, True)


def test_unfolded_dispatch_on_the_card(cuda):
    """``fold=False`` sends CUDA tensors to K3u / K4u and never to the plain
    versions; the wrappers refuse parameters that do not fit the rows."""
    gen = torch.Generator().manual_seed(11)
    x, aux, params, hw, hb = _unfolded_case(gen, "actor", 50, 110, 64, 2, True, True, False,
                                            cuda)
    cb.reset_launches()
    FP.actor_ppo_grads_packed(x, aux, params, hw, hb, torch.zeros(2, device=cuda), n_layers=2,
                              fold=False)
    x, caux, cparams, cw, cb_ = _unfolded_case(gen, "critic", 50, 440, 64, 2, True, True, False,
                                               cuda)
    FP.critic_value_grads_packed(x, caux, torch.tensor([0.0, 1.0], device=cuda), cparams, cw,
                                 cb_, n_layers=2, fold=False)
    assert cb.LAUNCHES == {"actor_ppo_grads_unfolded": 1, "critic_ppo_grads_unfolded": 1}
    with pytest.raises(ValueError, match="shapes"):
        FP.actor_grads_unfolded_cuda(x, aux, params, hw, hb, torch.zeros(2, device=cuda),
                                     n_layers=2, use_fn=True, use_relu=True, bf16=False,
                                     clip_param=0.2)


@pytest.mark.parametrize("kind", ["actor", "critic"])
@pytest.mark.parametrize("bf16", [False, True])
def test_unfolded_grads_at_16_envs(cuda, kind, bf16):
    """K3u / K4u at the main path's 16-env shapes: T*E*A = 9,600 actor rows
    of 110, T*E = 2,400 critic rows of 440."""
    rows, d_in = (9600, 110) if kind == "actor" else (2400, 440)
    gen = torch.Generator().manual_seed(rows + 7)
    x, aux, params, hw, hb = _unfolded_case(gen, kind, rows, d_in, 256, 2, True, True, bf16,
                                            cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16, clip_param=0.2)
    got = _unfolded(kind, x, aux, params, hw, hb, True, **kw)
    want = _unfolded(kind, x, aux, params, hw, hb, False, **kw)
    _assert_unfolded_close(got, want, bf16)


# The one-card presets' row widths, at their 16 envs: (preset, agents, actor
# width, critic width). Every one is not a multiple of 16, so the bf16
# kernels zero-pad them (64, 176, 192, 960, 128, 1,232).
PRESET_WIDTHS = [("3uav_small", 3, 58, 174), ("5uav_dense_conn", 5, 192, 960),
                 ("10uav_moving_collision", 10, 122, 1220)]


def _f32_outside(got32, want, tol):
    """The kernel computed in f32 lands outside the bf16 bound."""
    assert max(_rel(g, w) for g, w in zip(got32, want)) > tol


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("preset,agents,actor_w,critic_w", PRESET_WIDTHS,
                         ids=[p[0] for p in PRESET_WIDTHS])
def test_trunk_kernels_at_preset_widths(cuda, preset, agents, actor_w, critic_w, bf16):
    """K2 on the rollout's E*A actor and E critic rows, K2b on the update's
    T*E*A rows of each width (the critic's env rows duplicated per agent),
    under the bounds above; a bf16 check also requires the kernel computed
    in f32 to land outside its bound."""
    gen = torch.Generator().manual_seed(actor_w + critic_w)
    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16)
    for width, fwd_rows in ((actor_w, 16 * agents), (critic_w, 16)):
        params = _trunk_params(gen, width, 256, 2, True, cuda)
        x = torch.randn(fwd_rows, width, generator=gen).to(cuda)
        cb.reset_launches()
        got = FM.trunk_forward_cuda(x, params, **kw)
        assert cb.LAUNCHES["fused_mlp"] == 1 and cb.TILE["fused_mlp"] in (1, 8, 16, 32, 64)
        want = FM.trunk_forward_plain(x, params, **kw)
        assert _rel(got, want) < (2e-3 if bf16 else 1e-5)
        if bf16:
            _f32_outside([FM.trunk_forward_cuda(x, params, **{**kw, "bf16": False})], [want],
                         2e-3)
        rows = 150 * 16 * agents
        x = torch.randn(rows, width, generator=gen).to(cuda)
        x = x.bfloat16() if bf16 else x
        g = _cotangent(gen, x, params, 256, 2, True, True, bf16)
        dx, grads = FM.trunk_backward_cuda(x, params, g, **kw)
        want_dx, want = FM.trunk_backward_plain(x, params, g, **kw)
        for got, ref in zip([dx, *grads], [want_dx, *want]):
            assert _rel(got, ref) < (4e-3 if bf16 else 1e-4)
        if bf16:
            dx32, g32 = FM.trunk_backward_cuda(x, params, g, **{**kw, "bf16": False})
            _f32_outside([dx32, *g32], [want_dx, *want], 4e-3)


@pytest.mark.parametrize("trunk", ["model", "one_relu_layer"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("preset,agents,actor_w,critic_w", PRESET_WIDTHS,
                         ids=[p[0] for p in PRESET_WIDTHS])
def test_ppo_kernels_at_preset_widths(cuda, preset, agents, actor_w, critic_w, bf16, trunk):
    """K3 on the T*E*A actor rows and K4 on the T*E critic rows of the
    preset's bf16 run (``_ppo_at_widths``)."""
    _ppo_at_widths(cuda, agents, actor_w, critic_w, bf16, trunk,
                   "dcc_critic_grads" + ("_mma" if bf16 else ""))


@pytest.mark.parametrize("trunk", ["model", "one_relu_layer"])
@pytest.mark.parametrize("bf16", [False, True])
def test_ppo_kernels_at_20uav_widths(cuda, bf16, trunk):
    """The same at the 20-UAV preset's widths: K3 on 48,000 x 242 actor
    rows, K4 on 2,400 x 4,840 critic rows, in bf16 through its chunked
    layer 0 and the dV0 kernel."""
    _ppo_at_widths(cuda, 20, 242, 4840, bf16, trunk,
                   "dcc_critic_grads" + ("_chunked_mma" if bf16 else ""))
    assert cb.LAUNCHES["critic_ppo_grads_dv0"] == (1 if bf16 else 0)


def _ppo_at_widths(cuda, agents, actor_w, critic_w, bf16, trunk, critic_entry):
    """K3 on the T*E*A actor rows and K4 on the T*E critic rows of a
    preset's 16-env bf16 run, on one of ``chip_smoke.check_ppo``'s trunks, K4
    through ``critic_entry``. "model":
    2 layers and the feature norm, relu in f32 and tanh in bf16: with relu
    the bf16 kink rule misses rows a few bf16 steps from the kink, which a
    flipped rounding of the layer's input moves across it
    (``scripts/width_probe.py``). "one_relu_layer": one relu layer fed the
    rows themselves (no feature norm), where both sides feed the kinked
    layer the same input and the kink rules hold. Rows next to a relu kink
    (``relu_kink_rows_folded``: in f32 within 1e-5, K2b's f32 rule; in bf16
    within one bf16 step) get a zero advantage / valid = 0. A bf16 check
    also requires the kernel computed in f32 to land outside its bound."""
    n_layers, use_fn = (2, True) if trunk == "model" else (1, False)
    relu = not bf16 or trunk != "model"
    gen = torch.Generator().manual_seed(actor_w * critic_w + (trunk != "model"))
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=relu, bf16=bf16, clip_param=0.2)
    tol = 4e-3 if bf16 else 1e-3

    def case(kind, rows, width, col):
        x, aux, kp, hw, hb = _ppo_case(gen, kind, rows, width, 256, n_layers, use_fn, cuda)
        x = x.bfloat16() if bf16 else x
        if relu:
            aux[FP.relu_kink_rows_folded(x, kp, n_layers, use_fn, bf16=bf16), col] = 0.0
        return x, aux, kp, hw, hb

    log_std = torch.tensor([-0.3, 0.2], device=cuda)
    x, aux, kp, hw, hb = case("actor", 2400 * agents, actor_w, 3)
    got = FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std, **kw)
    want = FP.actor_grads_plain(x, aux, kp, hw, hb, log_std, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < tol
    if bf16:
        _f32_outside(_flat(FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std,
                                               **{**kw, "bf16": False})), _flat(want), tol)
    x, aux, kp, hw, hb = case("critic", 2400, critic_w, 2)
    norm = torch.tensor([0.5, 2.0], device=cuda)
    ckw = dict(kw, huber_delta=10.0, use_huber=True, use_clipped=True)
    cb.reset_launches()
    got = FP.critic_grads_cuda(x, aux, norm, kp, hw, hb, **ckw)
    assert cb.ENTRY["critic_ppo_grads"] == critic_entry
    want = FP.critic_grads_plain(x, aux, norm, kp, hw, hb, **ckw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < tol
    if bf16:
        _f32_outside(_flat(FP.critic_grads_cuda(x, aux, norm, kp, hw, hb,
                                                **{**ckw, "bf16": False})), _flat(want), tol)


@pytest.mark.parametrize("kind", ["actor", "critic"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("preset,agents,actor_w,critic_w", PRESET_WIDTHS,
                         ids=[p[0] for p in PRESET_WIDTHS])
def test_unfolded_kernels_at_preset_widths(cuda, preset, agents, actor_w, critic_w, bf16,
                                           kind):
    """K3u on the T*E*A actor rows, K4u on the T*E critic rows, with the
    kink and value-flip rules of ``_unfolded_case``."""
    rows, d_in = (2400 * agents, actor_w) if kind == "actor" else (2400, critic_w)
    gen = torch.Generator().manual_seed(rows + d_in + 13)
    x, aux, params, hw, hb = _unfolded_case(gen, kind, rows, d_in, 256, 2, True, True, bf16,
                                            cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=True, bf16=bf16, clip_param=0.2)
    got = _unfolded(kind, x, aux, params, hw, hb, True, **kw)
    want = _unfolded(kind, x, aux, params, hw, hb, False, **kw)
    _assert_unfolded_close(got, want, bf16)
    if bf16:
        f32 = _unfolded(kind, x, aux, params, hw, hb, True, **{**kw, "bf16": False})
        _f32_outside(_flat(f32), _flat(want), 4e-3)


# The kernels' shared-memory layouts in Python, for the tests that pretend a
# CUDA device on a host without nvcc (tests/test_torch_presets.py): K2
# ``fwd_mma_smem_bytes``, staged and chunked (csrc/fused_mlp.cu), K2b ``bwd_mma_layout`` and
# the layer-0 input backward's ``l0_layout`` (csrc/fused_mlp_bwd.cu), K3 /
# K4 and K3u / K4u ``ppo_mma_layout`` and ``ppo_*smem_floats``
# (csrc/fused_ppo.cu), each chunked layout too. The package reads the sizes
# from the libraries (``ops.tiles.smem_bytes``);
# ``test_row_tile_mirror_matches_the_libraries`` holds the two equal.
_MMA_KS, _MMA_STAGES, _MMA_WARPS, _MMA_HMAX, _MMA_KC = 32, 3, 8, 256, 256  # csrc/trunk_mma.cuh
_RESUM_BYTES = 16 + 8 * 128


def _pad16(n):
    return (n + 15) // 16 * 16


def _ring_stage(np_, nk):
    return np_ * (_MMA_KS + 8) if nk else _MMA_KS * (np_ + 8)


def _pass_cols(np_):
    """Columns of a layer's widest column pass (csrc/trunk_mma.cuh)."""
    return min(np_, _MMA_HMAX)


def _red(br):
    return 4 * (_MMA_WARPS // (br // 16)) * br * 2


def _ring_bytes(br, stage, blocked):
    """The gradient kernels' weight ring (csrc/trunk_mma.cuh ``ring_bytes``):
    column-blocked, each stage also holds a first operand's K-slice, and
    grad_at_g_blocked's two column blocks lie over the ring."""
    if not blocked:
        return 2 * _MMA_STAGES * stage
    return max(2 * _MMA_STAGES * (stage + br * (_MMA_KS + 8)), 4 * br * (_MMA_HMAX + 8))


def _mma_chain_bytes(br, d_in, hidden, n_layers, unfolded, chunked=False, deep=False,
                     blocked=False):
    """The rows (chunked: one column chunk of them), activations, staging
    and weight ring shared by the K2b and K3 / K4 tensor-core layouts, and
    their LN statistics (``deep``: the depth layout's one activation tile,
    its own g_prev stage past one column pass, no statistics;
    ``blocked``: the column-blocked layout's rows and ring alone)."""
    kp0, hp = _pad16(d_in), _pad16(hidden)
    ldh = hp + 8
    deep = deep or blocked
    kept = 0 if deep else n_layers  # layers whose tiles and statistics stay in shared memory
    tile = 0 if blocked else 2 * br * ldh  # a bf16 tile H wide in shared memory
    gprev0 = unfolded and not chunked  # layer 0's g_prev, staged over the dead tiles
    nk = _pass_cols(kp0) if gprev0 else 0
    nh = _pass_cols(hp)  # a layer's column pass; wider layers' g_prev over the dead tiles
    o = 2 * br * ((_MMA_KC if chunked else kp0) + 8) + (1 if deep else n_layers) * tile + tile
    if deep and hp > _MMA_HMAX and not blocked:
        o += 4 * br * (hp + 4)
    if gprev0 and not blocked:
        o = max(o, 4 * br * (kp0 + 4))
    o += tile
    o += _ring_bytes(br, max(_ring_stage(nh, False), _ring_stage(max(nk, nh), True)), blocked)
    o += 4 * kept * br * 2 + (8 * br if unfolded or chunked else 0)
    return o + _red(br) + (0 if blocked else 4 * (3 if unfolded else 1) * (br // 16) * hp)


def smem_layout(kernel, bf16, br, d_in, hidden, n_layers, n_head=1, chunked=False, deep=False,
                blocked=False):
    """Shared memory of one ``br``-row tile of ``kernel`` (``chunked``: its
    chunked layout; ``deep``: its depth layout; ``blocked``: its
    column-blocked layout), as ``ops.tiles.smem_bytes`` reads it from the
    libraries."""
    unfolded = kernel.endswith("_unfolded")
    hp = _pad16(hidden)
    kept = 0 if deep or blocked else n_layers
    if kernel == "layer0_input_bwd":  # g0 rows, the ring, the f32 xhat chunk, sums
        return ((0 if blocked else 2 * br * (hp + 8))
                + _ring_bytes(br, _ring_stage(_MMA_HMAX, True), blocked)
                + 4 * br * (_MMA_HMAX + 4) + 4 * 2 * (br // 16) * _MMA_HMAX + _red(br)
                + 8 * br)
    if kernel == "fused_mlp":
        if not bf16:
            return 4 * br * (max(d_in, hidden) + hidden)
        # past one column pass, the layer's activations (column-blocked: in
        # the scratch, with the later layers' input, which the ring streams)
        act = 2 * br * (hp + 8) if hp > _MMA_HMAX and not blocked else 0
        ring = _MMA_STAGES * (_ring_stage(_pass_cols(hp), False)
                              + (br * (_MMA_KS + 8) if blocked else 0))
        wide = 0 if blocked else hp
        if chunked:  # a chunk of the rows (then a layer's input), ring, sums, row statistics
            return 2 * (br * (max(_MMA_KC, wide) + 8) + ring) + _red(br) + 8 * br + act
        wmax = max(_pad16(d_in), wide)
        return 2 * (br * (wmax + 8) + ring) + _red(br) + act
    chain = br * (2 * d_in + 3 * n_layers * hidden + n_layers + 1)  # f32 unfolded floats
    if kernel == "fused_mlp_bwd":
        if not bf16:
            return 4 * chain
        return (_mma_chain_bytes(br, d_in, hidden, n_layers, True, chunked, deep, blocked)
                + 4 * br + 4 * kept * hp + _RESUM_BYTES)
    if bf16:
        o = _mma_chain_bytes(br, d_in, hidden, n_layers, unfolded, chunked, deep, blocked)
        o += 0 if blocked else 4 * hidden * n_head
        o += 0 if unfolded else 4 * kept * hidden
        o += 4 * br * n_head * 2 + 8 * br
        if unfolded:
            o += 4 * br + 4 * kept * hp + _RESUM_BYTES
        return o
    if unfolded:
        return 4 * (chain + br * (hidden + 2 * n_head + 2))
    return 4 * br * (d_in + 2 * n_layers * hidden + hidden + n_layers + 2 * n_head + 2)


def pretend_cuda(monkeypatch):
    """Pretend a CUDA device to code that only asks for one, as MAPPO's
    construction does, with the kernels' tile sizes from ``smem_layout``
    (their libraries need nvcc)."""
    from dcc_tpu_torch.ops import tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tiles, "smem_bytes", smem_layout)


def test_row_tile_mirror_matches_the_libraries(cuda):
    """``smem_layout``, which the tests that pretend a CUDA device read,
    gives each kernel's shared memory per row tile as the built libraries
    do (``ops.tiles.smem_bytes``, which MAPPO and the wrappers read), in
    every layout: staged, chunked and, for the bf16 gradient kernels, the
    depth layout of both, at 2, 9 and 32 layers; the column-blocked layout
    of both (``tiles.BLOCKED``) at hidden widths to 6,144."""
    from dcc_tpu_torch.ops import tiles

    for (kernel, bf16), sizes in tiles.SIZES.items():
        key = (kernel, bf16)
        n_head = 2 if kernel.startswith("actor") else 1
        layouts = [(False, False, False, sizes + tiles.LAST.get(key, ()))]
        if key in tiles.CHUNKED:
            layouts.append((True, False, False, tiles.CHUNKED[key]))
        if key in tiles.DEEP:
            layouts.append((False, True, False, tiles.DEEP[key]))
            layouts.append((True, True, False, tiles.CHUNKED[key]))
        if key in tiles.BLOCKED:
            layouts.append((False, False, True, tiles.BLOCKED[key]))
            if key in tiles.CHUNKED:
                layouts.append((True, False, True, tiles.CHUNKED[key]))
        for chunked, deep, blocked, tile_sizes in layouts:
            widths = (256, 100, 264, 300, 512, 1024) + ((1152, 2048, 4096, 6144) if blocked
                                                        else ())
            for d_in in (58, 110, 174, 192, 242, 440, 960, 1220, 1475, 1510, 4840, 5840,
                         6040):
                for hidden in widths:
                    for n_layers in (2, 9, 32):
                        for br in tile_sizes:
                            want = tiles.smem_bytes(kernel, bf16, br, d_in, hidden, n_layers,
                                                    n_head, chunked, deep, blocked)
                            got = smem_layout(kernel, bf16, br, d_in, hidden, n_layers, n_head,
                                              chunked, deep, blocked)
                            assert got == want, (kernel, bf16, chunked, deep, blocked, br, d_in,
                                                 hidden, n_layers)


@pytest.mark.parametrize("rows", _RAGGED + [20000])
@pytest.mark.parametrize("trunk,x_bf16", [("tanh", True), ("tanh", False),
                                          ("one_relu_layer", True)])
def test_bf16_chunked_critic_on_tensor_cores(cuda, rows, trunk, x_bf16):
    """bf16 K4 at the 20-UAV preset's 4,840-wide critic rows, which no staged
    tile takes: the chunked kernel (layer 0 over d_in in 256-column chunks,
    the last 240 wide) and the dV0 kernel, on row counts around its 16- and
    32-row tiles (20,000 rows: several tiles per block), with bf16 or f32
    rows, against the plain version within 4e-3; the kernel computed in f32
    lands outside. The trunks are ``chip_smoke.trunk_variants``' checks (the
    model's with tanh; one relu layer fed the rows, whose rows next to the
    kink get valid = 0): the model's relu trunk is no check for bf16
    (ROADMAP C3; it read 4.7e-3 at 20,000 rows on the H100)."""
    n_layers, use_fn, use_relu = (2, True, False) if trunk == "tanh" else (1, False, True)
    gen = torch.Generator().manual_seed(rows + 4840)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", rows, 4840, 256, n_layers, use_fn, cuda)
    x = x.bfloat16() if x_bf16 else x
    if use_relu:
        aux[FP.relu_kink_rows_folded(x, kp, n_layers, use_fn), 2] = 0.0
    norm = torch.tensor([0.5, 2.0], device=cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2,
              huber_delta=10.0, use_huber=True, use_clipped=True)
    cb.reset_launches()
    got = FP.critic_grads_cuda(x, aux, norm, kp, hw, hb, **kw)
    assert dict(cb.LAUNCHES) == {"critic_ppo_grads": 1, "critic_ppo_grads_dv0": 1}
    assert cb.ENTRY == {"critic_ppo_grads": "dcc_critic_grads_chunked_mma",
                        "critic_ppo_grads_dv0": "dcc_dv0_wgmma"}
    want = FP.critic_grads_plain(x, aux, norm, kp, hw, hb, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < 4e-3
    if rows > 1:
        _f32_outside(_flat(FP.critic_grads_cuda(x, aux, norm, kp, hw, hb,
                                                **{**kw, "bf16": False})), _flat(want), 4e-3)


def _g0(gen, rows, hidden, dev):
    """A bf16 cotangent of layer 0, (rows, pad16(hidden)), padding zero."""
    g0 = torch.zeros(rows, FM.pad16(hidden), dtype=torch.bfloat16, device=dev)
    g0[:, :hidden] = 0.1 * torch.randn(rows, hidden, generator=gen).to(dev)
    return g0


# the layer-0 tail's shapes: rows at the dV0 kernel's flush (512) and the
# steps' edges (1, 37, 511, 513, 20,000), d_in 17 (odd: bf16 x by plain
# loads), 1,000, 1,510 (rows not 16-byte aligned: 4-byte copies), 4,840,
# 6,040, hidden 8 to 1,024 (past 256 the dV0 kernel's column passes and the
# row-tiled layer-0 input backward)
TAIL_CASES = [(1, 4840, 256), (37, 4840, 256), (511, 1510, 256), (512, 1510, 100),
              (513, 4840, 264), (2400, 4840, 256), (20000, 4840, 256), (20000, 1510, 512),
              (513, 6040, 1024), (333, 1000, 64), (100, 17, 8), (20000, 6040, 100),
              (37, 1000, 512), (512, 17, 256)]


@pytest.mark.parametrize("x_bf16", [True, False])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("rows,d_in,hidden", TAIL_CASES)
def test_dv0_kernel_matches_plain(cuda, rows, d_in, hidden, affine, x_bf16):
    """The dV0 kernel (``dcc_dv0_wgmma``), bf16((x - mu) * inv)^T g0
    (affine: bf16((x - mu) * inv * fs + fb)^T g0, the unfolded chain's dW0)
    over row splits summed in order, against its plain version: the same
    bf16 operands, so only the f32 summation order differs (bound 1e-4, as
    chip_smoke's DV0_REL), x in bf16 and f32; one launch."""
    gen = torch.Generator().manual_seed(rows + d_in + hidden)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    x = x.bfloat16() if x_bf16 else x
    xstats = FM.input_stats(x, True)
    g0 = _g0(gen, rows, hidden, cuda)
    aff = None
    if affine:
        aff = ((1.0 + 0.1 * torch.randn(d_in, generator=gen)).to(cuda),
               (0.1 * torch.randn(d_in, generator=gen)).to(cuda))
    cb.reset_launches()
    got = FM.dv0_cuda(x, xstats, g0, hidden, aff, unfolded=affine)
    assert dict(cb.LAUNCHES) == {"dv0_unfolded" if affine else "critic_ppo_grads_dv0": 1}
    assert cb.ENTRY == {"dv0_unfolded" if affine else "critic_ppo_grads_dv0": "dcc_dv0_wgmma"}
    assert _rel(got, FM.dv0_plain(x, xstats, g0, hidden, aff)) < 1e-4


@pytest.mark.parametrize("use_fn,need_dx", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("rows,d_in,hidden", TAIL_CASES)
@pytest.mark.parametrize("x_bf16", [True, False])
def test_layer0_input_bwd_kernel_matches_plain(cuda, rows, d_in, hidden, use_fn, need_dx,
                                               x_bf16):
    """The layer-0 input backward of the chunked K2b / K4u (g_prev = g0 W_0^T
    on the tensor cores, the feature norm's scale and bias gradients and dx
    in f32) against its plain version on the same bf16 operands: f32
    summation order only, within 1e-4 (dx off: it is None; without the
    feature norm dx = g_prev). With the feature norm and without dx at
    hidden widths to 256 the warpgroup kernel (``dcc_layer0_input_bwd_wgmma``)
    runs, else the row-tiled one."""
    gen = torch.Generator().manual_seed(rows + d_in + 3 * use_fn + need_dx)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    x = x.bfloat16() if x_bf16 else x
    xstats = FM.input_stats(x, use_fn)
    g0 = _g0(gen, rows, hidden, cuda)
    w0 = torch.randn(d_in, hidden, generator=gen).to(cuda) * d_in ** -0.5
    w0b = FM.pack_mma_weights([w0], cuda)[0].view(FM.pad16(d_in), FM.pad16(hidden))
    fs = (1.0 + 0.1 * torch.randn(d_in, generator=gen)).to(cuda) if use_fn else None
    cb.reset_launches()
    got = FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, fs, hidden, need_dx)
    assert dict(cb.LAUNCHES) == {"layer0_input_bwd": 1}
    tail = use_fn and not need_dx and FM.pad16(hidden) <= 256
    assert cb.ENTRY["layer0_input_bwd"] == ("dcc_layer0_input_bwd_wgmma" if tail
                                            else "dcc_layer0_input_bwd_mma")
    want = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, fs, hidden, need_dx)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and _rel(g, w) < 1e-4


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("rows,d_in,hidden", [(513, 4840, 256), (20000, 1510, 256),
                                              (37, 6040, 100), (512, 1000, 512)])
def test_layer0_tail_matches_plain(cuda, rows, d_in, hidden, need_dx):
    """``layer0_tail`` on CUDA tensors (the layer-0 input backward and dV0
    in its affine mode, two launches) against its plain path on the same
    operands: dfs, dfb, dW0 (and dx) within 1e-4."""
    gen = torch.Generator().manual_seed(rows + d_in + hidden + need_dx)
    x = torch.randn(rows, d_in, generator=gen).to(cuda).bfloat16()
    xstats = FM.input_stats(x, True)
    g0 = _g0(gen, rows, hidden, cuda)
    w0 = torch.randn(d_in, hidden, generator=gen).to(cuda) * d_in ** -0.5
    w0b = FM.pack_mma_weights([w0], cuda)[0].view(FM.pad16(d_in), FM.pad16(hidden))
    fs = (1.0 + 0.1 * torch.randn(d_in, generator=gen)).to(cuda)
    fb = (0.1 * torch.randn(d_in, generator=gen)).to(cuda)
    cb.reset_launches()
    dx, got = FM.layer0_tail(x, xstats, g0, w0b, fs, fb, hidden, need_dx)
    assert dict(cb.LAUNCHES) == {"layer0_input_bwd": 1, "dv0_unfolded": 1}
    cpu = lambda t: t.cpu()
    dx2, want = FM.layer0_tail(*map(cpu, (x, xstats, g0, w0b, fs, fb)), hidden, need_dx)
    assert (dx is None) == (dx2 is None) == (not need_dx)
    for g, w in zip(got + ([dx] if need_dx else []), want + ([dx2] if need_dx else [])):
        assert _rel(g.cpu(), w) < 1e-4


def test_tail_smem_mirror(cuda):
    """``ops.tiles.tail_smem_bytes`` is the library's layout of the layer-0
    tail's blocks, in each way x is copied."""
    lib = cb.library("layer0_tail")
    l0_code = {"bf16": 0, "bf16_window": 1, "f32": 2, "f32_window": 2}
    for xmode in FM.tiles.TAIL_XMODES:
        assert FM.tiles.tail_smem_bytes("dv0", xmode, 256) == lib.dcc_dv0_wgmma_smem_bytes(
            int(xmode.startswith("bf16")), int(xmode.endswith("window")))
        for hidden in (8, 100, 256):
            assert FM.tiles.tail_smem_bytes("layer0_input_bwd", xmode, hidden) == \
                lib.dcc_layer0_input_bwd_wgmma_smem_bytes(l0_code[xmode], hidden)


@pytest.mark.parametrize("kernel", ["dv0", "layer0"])
def test_tail_takes_unaligned_rows(cuda, kernel):
    """Rows of a view that starts off a 16-byte boundary (the window copy)
    give the same dV0 and layer-0 input backward as the same rows copied to
    a fresh tensor."""
    gen = torch.Generator().manual_seed(5)
    big = torch.randn(1001, 4840, generator=gen).to(cuda).bfloat16()
    x = big.view(-1)[3: 3 + 1000 * 4840].view(1000, 4840)
    assert x.data_ptr() % 16 and x.is_contiguous()
    xstats = FM.input_stats(x, True)
    g0 = _g0(gen, 1000, 256, cuda)
    w0 = torch.randn(4840, 256, generator=gen).to(cuda) * 4840 ** -0.5
    w0b = FM.pack_mma_weights([w0], cuda)[0].view(4848, 256)
    fs = (1.0 + 0.1 * torch.randn(4840, generator=gen)).to(cuda)
    run = ((lambda xx: [FM.dv0_cuda(xx, xstats, g0, 256)]) if kernel == "dv0" else
           (lambda xx: FM.layer0_input_bwd_cuda(xx, xstats, g0, w0b, fs, 256, False)[1:]))
    for g, w in zip(run(x), run(x.clone())):
        assert _rel(g, w) < 1e-6


# the 20-UAV preset's gated bf16 trunks at its critic width (chip_smoke's
# trunk_variants): (n_layers, use_fn, use_relu)
WIDE_TRUNKS = {"tanh": (2, True, False), "one_relu_layer": (1, False, True)}


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("trunk", list(WIDE_TRUNKS))
@pytest.mark.parametrize("rows", [1, 37, 2400, 20000])
def test_bf16_chunked_trunk_backward_on_tensor_cores(cuda, rows, trunk, need_dx):
    """bf16 K2b at the 20-UAV preset's 4,840-wide critic rows, which no staged
    tile takes: the chunked kernel (the chain to layer 0's cotangent), the
    layer-0 input backward (with the feature norm, or for dx) and the dV0
    kernel, on row counts around its 16- and 32-row tiles (37: a ragged
    last tile; 20,000: several tiles per block), against the one-pass plain
    version within 4e-3, the kernel computed in f32 outside. On the tanh
    trunk and on one relu layer fed the rows (rows next to its kink get a
    zero cotangent); the model's relu trunk is no check in bf16 (ROADMAP
    C3)."""
    n_layers, use_fn, use_relu = WIDE_TRUNKS[trunk]
    gen = torch.Generator().manual_seed(rows + 4840 + need_dx)
    params = _trunk_params(gen, 4840, 256, n_layers, use_fn, cuda)
    x = torch.randn(rows, 4840, generator=gen).to(cuda).bfloat16()
    g = _cotangent(gen, x, params, 256, n_layers, use_fn, use_relu, True)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True)
    cb.reset_launches()
    dx, grads = FM.trunk_backward_cuda(x, params, g, need_dx=need_dx, **kw)
    want = {"fused_mlp_bwd_chunked": 1, "dv0_unfolded": 1}
    if use_fn or need_dx:
        want["layer0_input_bwd"] = 1
    assert dict(cb.LAUNCHES) == want
    assert cb.ENTRY["fused_mlp_bwd_chunked"] == "dcc_trunk_bwd_chunked_mma"
    want_dx, want_grads = FM.trunk_backward_plain(x, params, g, **kw)
    assert (dx is None) != need_dx
    got, ref = ([dx] if need_dx else []) + grads, ([want_dx] if need_dx else []) + want_grads
    for a, b in zip(got, ref):
        assert _rel(a, b) < 4e-3
    if rows > 1:
        dx32, g32 = FM.trunk_backward_cuda(x, params, g, **{**kw, "bf16": False})
        _f32_outside([dx32, *g32], [want_dx, *want_grads], 4e-3)


@pytest.mark.parametrize("trunk", list(WIDE_TRUNKS))
@pytest.mark.parametrize("rows", [1, 37, 2400, 20000])
def test_bf16_chunked_critic_unfolded_on_tensor_cores(cuda, rows, trunk):
    """bf16 K4u at the 20-UAV preset's 4,840-wide critic rows: the chunked
    kernel, the layer-0 input backward without dx (with the feature norm)
    and the dV0 kernel in its affine mode, with the kink and value-flip
    rules of ``_unfolded_case``, against the plain version within 4e-3, the
    kernel computed in f32 outside."""
    n_layers, use_fn, use_relu = WIDE_TRUNKS[trunk]
    gen = torch.Generator().manual_seed(rows + 4840 + 17)
    x, aux, params, hw, hb = _unfolded_case(gen, "critic", rows, 4840, 256, n_layers, use_fn,
                                            use_relu, True, cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2)
    cb.reset_launches()
    got = _unfolded("critic", x, aux, params, hw, hb, True, **kw)
    want = {"critic_ppo_grads_unfolded": 1, "dv0_unfolded": 1}
    if use_fn:
        want["layer0_input_bwd"] = 1
    assert dict(cb.LAUNCHES) == want
    assert cb.ENTRY["critic_ppo_grads_unfolded"] == "dcc_critic_grads_unfolded_chunked_mma"
    ref = _unfolded("critic", x, aux, params, hw, hb, False, **kw)
    assert [tuple(g.shape) for g in got[0]] == [tuple(p.shape) for p in params]
    _assert_unfolded_close(got, ref, True)
    if rows > 1:
        f32 = _unfolded("critic", x, aux, params, hw, hb, True, **{**kw, "bf16": False})
        _f32_outside(_flat(f32), _flat(ref), 4e-3)


def test_20uav_preset_builds_on_the_card(cuda):
    """The 20-UAV preset builds on the card, bf16 K4 taking its 4,840-wide
    critic rows in the chunked layout (``ops.tiles.plan``)."""
    from dcc_tpu_torch.algos import MAPPO
    from dcc_tpu_torch.configs import load_preset
    from dcc_tpu_torch.ops import tiles

    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    assert tiles.plan("critic_ppo_grads", True, 4840, 256, 2) == (True, [32, 16], False, False)
    algo = MAPPO(algo_cfg, env_cfg, device=cuda)
    assert algo.fused_loss and algo.fused_trunk


# the 20-UAV runs whose critic rows take the chunked K2b or K4u, and the
# launches of one iteration at 2 epochs: the fused loss off (4 update
# chunks: K2b on each, actor staged, critic chunked), unfolded (K3u at 242,
# K4u chunked), recurrent (no update chunks: K2b once per network and epoch)
WIDE_RUNS = {
    "fused-loss-off": ({"fused_loss": "off"},
                       {"fused_mlp_bwd": 8, "fused_mlp_bwd_chunked": 8, "layer0_input_bwd": 8,
                        "dv0_unfolded": 8}),
    "unfolded": ({"fused_fold": False},
                 {"actor_ppo_grads_unfolded": 2, "critic_ppo_grads_unfolded": 2,
                  "layer0_input_bwd": 2, "dv0_unfolded": 2}),
    "recurrent": ({"use_recurrent_policy": True, "update_chunks": 1},
                  {"fused_mlp_bwd": 2, "fused_mlp_bwd_chunked": 2, "layer0_input_bwd": 2,
                   "dv0_unfolded": 2}),
}


@pytest.mark.parametrize("case", list(WIDE_RUNS))
def test_20uav_preset_trains_on_the_card(cuda, case):
    """The 20-UAV preset with the fused loss off, unfolded or recurrent builds
    on the card and trains one iteration (8 envs, 2 epochs, widths intact):
    its 4,840-wide critic rows go through the chunked kernels, launched
    exactly as the path runs them (K2 and K1 besides), with finite
    metrics."""
    import math

    from dcc_tpu_torch.algos import MAPPO
    from dcc_tpu_torch.configs import load_preset

    override, launches = WIDE_RUNS[case]
    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist", overrides={
        "n_rollout_threads": 8, "ppo_epoch": 2, "n_eval_rollout_threads": 0})
    algo = MAPPO(algo_cfg._replace(**override), env_cfg, device=cuda)
    ts = algo.init_state(0)
    cb.reset_launches()
    m = algo.train_iteration(ts)
    assert all(math.isfinite(v) for v in m)
    got = {k: v for k, v in cb.LAUNCHES.items() if k not in ("gae", "fused_mlp")}
    assert got == launches
    chunked = [k for k in launches if k.endswith("_chunked") or k == "critic_ppo_grads_unfolded"]
    assert {cb.ENTRY[k] for k in chunked} <= {"dcc_trunk_bwd_chunked_mma",
                                              "dcc_critic_grads_unfolded_chunked_mma"}


@pytest.mark.parametrize("fold", [True, False])
def test_20uav_wide_actor_rows_build_on_the_card(cuda, fold):
    """bf16 K3 and K3u take 4,840-wide rows in their chunked layouts
    (``ops.tiles.CHUNKED``): MAPPO's check passes such actor rows on the
    card, reading the built libraries' layouts."""
    from dcc_tpu_torch.algos import MAPPO
    from dcc_tpu_torch.configs import load_preset
    from dcc_tpu_torch.ops import tiles

    _, env_cfg, algo_cfg = load_preset("20uav_16k_dist")
    algo = MAPPO(algo_cfg._replace(fused_fold=fold), env_cfg, device=cuda)
    algo.obs_dim = env_cfg.share_obs_dim
    algo._check_row_tiles()
    kernel = "actor_ppo_grads" + ("" if fold else "_unfolded")
    assert tiles.plan(kernel, True, 4840, 256, 2, 2) == (True, [32, 16], False, False)


# the many-PoI widths: critic rows of 4 UAVs x 300 PoIs (6,040) and of 20 x 50
# (5,840), wider than any staged bf16 K2 tile (5,632); actor rows of 4 x 300
# (1,510), wider than any staged bf16 K3 (1,472) or K3u (1,088) tile. The
# trunks: WIDE_TRUNKS, and for K2, whose output is continuous at a relu kink,
# the model's (relu, two layers, the feature norm) too
POIS_ACTOR, POIS_CRITICS = 1510, (5840, 6040)
FWD_TRUNKS = {**WIDE_TRUNKS, "model": (2, True, True)}


@pytest.mark.parametrize("trunk", list(FWD_TRUNKS))
@pytest.mark.parametrize("d_in", POIS_CRITICS)
@pytest.mark.parametrize("rows", [1, 37, 2400, 20000])
def test_bf16_chunked_trunk_forward_on_tensor_cores(cuda, rows, d_in, trunk):
    """bf16 K2 at critic rows no staged tile takes: the chunked kernel (the
    rows' feature-norm statistics, then layer 0 over d_in in 256-column
    chunks, the last ragged: 6,040 = 23 x 256 + 152), one launch, on f32
    rows as the rollout gives them, on row counts around its 16- and 32-row
    tiles, against the plain version within 2e-3 (max abs 0.25, the
    smoke's K2 bounds); the kernel computed in f32 lands outside."""
    n_layers, use_fn, use_relu = FWD_TRUNKS[trunk]
    gen = torch.Generator().manual_seed(rows + d_in + n_layers)
    params = _trunk_params(gen, d_in, 256, n_layers, use_fn, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True)
    cb.reset_launches()
    got = FM.trunk_forward_cuda(x, params, **kw)
    assert dict(cb.LAUNCHES) == {"fused_mlp_chunked": 1}
    assert cb.ENTRY["fused_mlp_chunked"] == "dcc_trunk_fwd_chunked_mma"
    want = FM.trunk_forward_plain(x, params, **kw)
    assert got.dtype == torch.bfloat16 and _rel(got, want) < 2e-3
    assert float((got.float() - want.float()).abs().max()) <= 0.25
    if rows > 1:
        _f32_outside([FM.trunk_forward_cuda(x, params, **{**kw, "bf16": False})], [want], 2e-3)


# one layer's staged K3 tile takes actor rows up to 1,760 columns, so the
# one-relu-layer trunk runs the chunked K3 at 4 UAVs x 360 PoIs (1,810)
K3_WIDTHS = {"tanh": POIS_ACTOR, "one_relu_layer": 1810}


@pytest.mark.parametrize("trunk", list(WIDE_TRUNKS))
@pytest.mark.parametrize("rows", [1, 37, 2400, 20000])
def test_bf16_chunked_actor_on_tensor_cores(cuda, rows, trunk):
    """bf16 K3 at actor rows no staged tile takes (``K3_WIDTHS``): the chunked
    kernel (the loss, the Gaussian head's two columns and the backward to
    layer 0's cotangent) and the dV0 kernel, on row counts around its 16-
    and 32-row tiles, against the one-pass plain version within 4e-3; the
    kernel computed in f32 lands outside. Rows next to a relu kink get a
    zero advantage."""
    n_layers, use_fn, use_relu = WIDE_TRUNKS[trunk]
    d_in = K3_WIDTHS[trunk]
    gen = torch.Generator().manual_seed(rows + d_in)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", rows, d_in, 256, n_layers, use_fn, cuda)
    x = x.bfloat16()
    if use_relu:
        aux[FP.relu_kink_rows_folded(x, kp, n_layers, use_fn), 3] = 0.0
    log_std = torch.tensor([-0.3, 0.2], device=cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2)
    cb.reset_launches()
    got = FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std, **kw)
    assert dict(cb.LAUNCHES) == {"actor_ppo_grads": 1, "actor_ppo_grads_dv0": 1}
    assert cb.ENTRY == {"actor_ppo_grads": "dcc_actor_grads_chunked_mma",
                        "actor_ppo_grads_dv0": "dcc_dv0_wgmma"}
    want = FP.actor_grads_plain(x, aux, kp, hw, hb, log_std, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < 4e-3
    if rows > 1:
        _f32_outside(_flat(FP.actor_grads_cuda(x, aux, kp, hw, hb, log_std,
                                               **{**kw, "bf16": False})), _flat(want), 4e-3)


@pytest.mark.parametrize("trunk", list(WIDE_TRUNKS))
@pytest.mark.parametrize("rows", [1, 37, 2400, 20000])
def test_bf16_chunked_actor_unfolded_on_tensor_cores(cuda, rows, trunk):
    """bf16 K3u at 1,510-wide actor rows: the chunked kernel, the layer-0
    input backward without dx (with the feature norm) and the dV0 kernel in
    its affine mode, against the plain version within 4e-3, the kernel
    computed in f32 outside; rows next to a relu kink of the unfolded chain
    get a zero advantage."""
    n_layers, use_fn, use_relu = WIDE_TRUNKS[trunk]
    gen = torch.Generator().manual_seed(rows + POIS_ACTOR + 17)
    x, aux, params, hw, hb = _unfolded_case(gen, "actor", rows, POIS_ACTOR, 256, n_layers,
                                            use_fn, use_relu, True, cuda)
    kw = dict(n_layers=n_layers, use_fn=use_fn, use_relu=use_relu, bf16=True, clip_param=0.2)
    cb.reset_launches()
    got = _unfolded("actor", x, aux, params, hw, hb, True, **kw)
    want = {"actor_ppo_grads_unfolded": 1, "dv0_unfolded": 1}
    if use_fn:
        want["layer0_input_bwd"] = 1
    assert dict(cb.LAUNCHES) == want
    assert cb.ENTRY["actor_ppo_grads_unfolded"] == "dcc_actor_grads_unfolded_chunked_mma"
    ref = _unfolded("actor", x, aux, params, hw, hb, False, **kw)
    assert [tuple(g.shape) for g in got[0]] == [tuple(p.shape) for p in params]
    _assert_unfolded_close(got, ref, True)
    if rows > 1:
        f32 = _unfolded("actor", x, aux, params, hw, hb, True, **{**kw, "bf16": False})
        _f32_outside(_flat(f32), _flat(ref), 4e-3)


# 4 UAVs x 300 PoIs in bf16 at 8 envs and 2 epochs: the launches of one
# iteration beside K1 and the rollout's K2 (150 staged on the actor's rows,
# 151 chunked on the critic's): folded (K3 and K4 chunked, each with its
# dV0), unfolded (K3u and K4u chunked, each with the layer-0 input backward
# and dV0) and the fused loss off (autograd: K2 once more per network and
# epoch, K2b staged on the actor's rows, chunked on the critic's)
POIS_RUNS = {
    "folded": ({}, {"fused_mlp": 150, "fused_mlp_chunked": 151, "actor_ppo_grads": 2,
                    "critic_ppo_grads": 2, "actor_ppo_grads_dv0": 2,
                    "critic_ppo_grads_dv0": 2}),
    "unfolded": ({"fused_fold": False},
                 {"fused_mlp": 150, "fused_mlp_chunked": 151, "actor_ppo_grads_unfolded": 2,
                  "critic_ppo_grads_unfolded": 2, "layer0_input_bwd": 4, "dv0_unfolded": 4}),
    "fused-loss-off": ({"fused_loss": "off"},
                       {"fused_mlp": 152, "fused_mlp_chunked": 153, "fused_mlp_bwd": 2,
                        "fused_mlp_bwd_chunked": 2, "layer0_input_bwd": 2, "dv0_unfolded": 2}),
}


@pytest.mark.parametrize("case", list(POIS_RUNS))
def test_many_pois_trains_on_the_card(cuda, case):
    """The default env with 300 PoIs (actor rows 1,510, critic rows 6,040)
    in bf16 builds on the card and trains one iteration at 8 envs and 2
    epochs through the chunked kernels, launched exactly as the path runs
    them, with finite metrics."""
    import math

    from dcc_tpu_torch.algos import MAPPO
    from dcc_tpu_torch.configs import load

    override, launches = POIS_RUNS[case]
    _, env_cfg, algo_cfg = load(overrides={
        "num_pois": 300, "compute_dtype": "bfloat16", "n_rollout_threads": 8, "ppo_epoch": 2,
        "n_eval_rollout_threads": 0})
    assert (env_cfg.obs_dim, env_cfg.share_obs_dim) == (1510, 6040)
    algo = MAPPO(algo_cfg._replace(**override), env_cfg, device=cuda)
    ts = algo.init_state(0)
    cb.reset_launches()
    m = algo.train_iteration(ts)
    assert all(math.isfinite(v) for v in m)
    assert {k: v for k, v in cb.LAUNCHES.items() if k != "gae"} == launches
    assert cb.ENTRY["fused_mlp_chunked"] == "dcc_trunk_fwd_chunked_mma"


# ROADMAP B3's hidden widths: past one column pass (264 .. 1,024), off
# multiples of 8 (65 odd, 100) and within one pass (65, 100). Relu trunks
# are the model's (two layers, the feature norm); the kernel writes its relu
# masks (``relu_masks``), every mask that differs from the plain version's
# must lie within what a one-bf16-step change of the layer's input can move
# (``FM.relu_mask_gap``, ratio <= 1), and the plain version then takes the
# kernel's masks: the rest is held to the bf16 bounds.
WIDE_HIDDEN = [65, 100, 264, 300, 512, 1024]
HIDDEN_TRUNKS = {"tanh": False, "relu": True}


def _clip_kink_rows(feat, aux, hw, hb, log_std, clip=0.2):
    """(rows,) bool: actor rows whose plain ratio lies within what one bf16
    step of each head output (mean) moves it from a clip bound (1 +- clip),
    where the kernel and its plain version may take the other branch of the
    clipped surrogate and the row's whole cotangent with it; the wide-hidden
    checks give them a zero advantage, as the relu kink rows got before the
    mask rule."""
    mean = FM.dense(feat.float(), hw, hb, True)
    inv_std = torch.exp(-log_std)
    z = (aux[:, :2] - mean) * inv_std
    lp = torch.sum(-0.5 * z * z - log_std - FP.LOG_SQRT_2PI, dim=1)
    log_ratio = lp - aux[:, 2]
    slack = torch.sum(z.abs() * inv_std * _bf16_step(mean), dim=1)
    return torch.stack([(log_ratio - math.log(1.0 + b)).abs() <= slack
                        for b in (-clip, clip)]).any(dim=0)


def _masks(relu, n_layers, rows, hidden, dev):
    if not relu:
        return None
    return torch.zeros((n_layers, rows, hidden), dtype=torch.uint8, device=dev)


def _mask_ok(gap):
    n, worst = gap
    assert worst <= 1.0, f"{n} relu masks differ, up to {worst:.2f} of the rule's bound"


@pytest.mark.parametrize("trunk", list(HIDDEN_TRUNKS))
@pytest.mark.parametrize("hidden", WIDE_HIDDEN)
@pytest.mark.parametrize("rows,d_in", [(333, 110), (2000, 440)])
def test_bf16_trunk_kernels_at_wide_hidden(cuda, rows, d_in, hidden, trunk):
    """K2 and K2b at ROADMAP B3's hidden widths, against their plain
    versions within 2e-3 and 4e-3; the kernels computed in f32 land
    outside."""
    relu = HIDDEN_TRUNKS[trunk]
    gen = torch.Generator().manual_seed(rows + hidden)
    params = _trunk_params(gen, d_in, hidden, 2, True, cuda)
    x = torch.randn(rows, d_in, generator=gen).to(cuda).bfloat16()
    kw = dict(n_layers=2, use_fn=True, use_relu=relu, bf16=True)
    m = _masks(relu, 2, rows, hidden, cuda)
    got = FM.trunk_forward_cuda(x, params, relu_masks=m, **kw)
    if relu:
        _mask_ok(FM.relu_mask_gap(x, params, 2, True, m))
    want = FM.trunk_forward_plain(x, params, masks=m, **kw)
    assert _rel(got, want) < 2e-3
    g = (torch.randn(rows, hidden, generator=gen)).to(cuda).bfloat16()
    m = _masks(relu, 2, rows, hidden, cuda)
    cb.reset_launches()
    dx, grads = FM.trunk_backward_cuda(x, params, g, relu_masks=m, **kw)
    assert cb.ENTRY["fused_mlp_bwd"] == "dcc_trunk_bwd_mma"
    if relu:
        _mask_ok(FM.relu_mask_gap(x, params, 2, True, m))
    want_dx, want = FM.trunk_backward_plain(x, params, g, masks=m, **kw)
    for k, p in zip([dx, *grads], [want_dx, *want]):
        assert _rel(k, p) < 4e-3
    f32 = FM.trunk_backward_cuda(x, params, g, **{**kw, "bf16": False})
    _f32_outside([f32[0], *f32[1]], [want_dx, *want], 4e-3)


@pytest.mark.parametrize("trunk", list(HIDDEN_TRUNKS))
@pytest.mark.parametrize("hidden", WIDE_HIDDEN)
@pytest.mark.parametrize("kind", ["actor", "critic"])
def test_bf16_folded_grads_at_wide_hidden(cuda, kind, hidden, trunk):
    """K3 / K4 at ROADMAP B3's hidden widths on 2,000 rows (actor 110 wide,
    critic 440), against their plain versions within 4e-3."""
    relu = HIDDEN_TRUNKS[trunk]
    d_in = 110 if kind == "actor" else 440
    gen = torch.Generator().manual_seed(hidden + d_in)
    x, aux, kp, hw, hb = _ppo_case(gen, kind, 2000, d_in, hidden, 2, True, cuda)
    x = x.bfloat16()
    m = _masks(relu, 2, 2000, hidden, cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=relu, bf16=True, clip_param=0.2)
    if kind == "actor":
        ls = torch.tensor([-0.3, 0.2], device=cuda)
        run = lambda fn, **k: fn(x, aux, kp, hw, hb, ls, **{**kw, **k})
        cuda_fn, plain_fn = FP.actor_grads_cuda, FP.actor_grads_plain
    else:
        norm = torch.tensor([0.5, 2.0], device=cuda)
        kw.update(huber_delta=10.0, use_huber=True, use_clipped=True)
        run = lambda fn, **k: fn(x, aux, norm, kp, hw, hb, **{**kw, **k})
        cuda_fn, plain_fn = FP.critic_grads_cuda, FP.critic_grads_plain
    if kind == "actor":  # the clip's kink: the kernel's masks, then the plain ratio
        run(cuda_fn, relu_masks=m)
        feat = FP._fwd_folded(x, kp, 2, True, relu, True, m)[0]
        aux[_clip_kink_rows(feat, aux, hw, hb, ls), 3] = 0.0
    got = run(cuda_fn, relu_masks=m)
    if relu:
        _mask_ok(FP.relu_mask_gap_folded(x, kp, 2, True, m))
    want = run(plain_fn, masks=m)
    for g, w in zip(_flat(got), _flat(want)):
        assert _rel(g, w) < 4e-3
    _f32_outside(_flat(run(cuda_fn, bf16=False)), _flat(want), 4e-3)


@pytest.mark.parametrize("trunk", list(HIDDEN_TRUNKS))
@pytest.mark.parametrize("hidden", WIDE_HIDDEN)
@pytest.mark.parametrize("kind", ["actor", "critic"])
def test_bf16_unfolded_grads_at_wide_hidden(cuda, kind, hidden, trunk):
    """K3u / K4u at ROADMAP B3's hidden widths on 2,000 rows (the critic's
    440-wide rows at 1,024 take the chunked layout, with the layer-0 input
    backward and dV0), against their plain versions within 4e-3."""
    relu = HIDDEN_TRUNKS[trunk]
    d_in = 110 if kind == "actor" else 440
    gen = torch.Generator().manual_seed(hidden + d_in + 1)
    x, aux, params, hw, hb = _unfolded_case(gen, kind, 2000, d_in, hidden, 2, True, False,
                                            False, cuda)
    x = x.bfloat16()
    m = _masks(relu, 2, 2000, hidden, cuda)
    kw = dict(n_layers=2, use_fn=True, use_relu=relu, bf16=True, clip_param=0.2)
    if relu:  # the kernel's masks, for the plain features
        _unfolded(kind, x, aux, params, hw, hb, True, relu_masks=m, **kw)
    if kind == "critic":  # the rows whose value the kernel rounds apart
        flips = _value_flip_rows(x, aux, params, hw, hb, 2, True, relu, masks=m)
        assert len(flips) <= 3 + 2000 // 20
        aux[list(flips), 2] = 0.0
    else:  # the clip's kink
        feat = FM._forward_chain(x, params, 2, True, relu, True, m)[0]
        aux[_clip_kink_rows(feat, aux, hw, hb, torch.tensor([-0.3, 0.2], device=cuda)), 3] = 0.0
    got = _unfolded(kind, x, aux, params, hw, hb, True, relu_masks=m, **kw)
    if relu:
        _mask_ok(FM.relu_mask_gap(x, params, 2, True, m))
    want = _unfolded(kind, x, aux, params, hw, hb, False, masks=m, **kw)
    _assert_unfolded_close(got, want, True)
    f32 = _unfolded(kind, x, aux, params, hw, hb, True, **{**kw, "bf16": False})
    _f32_outside(_flat(f32), _flat(want), 4e-3)


@pytest.mark.parametrize("hidden", [264, 300, 512])
def test_bf16_chunked_kernels_at_wide_hidden(cuda, hidden):
    """The chunked layouts at ROADMAP B3's widths: K4 and K4u (with dV0 and
    the layer-0 input backward) and K2b on the 20-UAV preset's 4,840-wide
    critic rows, K3 on 1,510-wide actor rows, tanh trunks, within 4e-3."""
    gen = torch.Generator().manual_seed(hidden + 4840)
    kw = dict(n_layers=2, use_fn=True, use_relu=False, bf16=True, clip_param=0.2)
    ckw = dict(kw, huber_delta=10.0, use_huber=True, use_clipped=True)
    norm = torch.tensor([0.5, 2.0], device=cuda)
    x, aux, kp, hw, hb = _ppo_case(gen, "critic", 600, 4840, hidden, 2, True, cuda)
    cb.reset_launches()
    got = FP.critic_grads_cuda(x, aux, norm, kp, hw, hb, **ckw)
    assert cb.ENTRY["critic_ppo_grads"] == "dcc_critic_grads_chunked_mma"
    for g, w in zip(_flat(got), _flat(FP.critic_grads_plain(x, aux, norm, kp, hw, hb, **ckw))):
        assert _rel(g, w) < 4e-3
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", 600, 1510, hidden, 2, True, cuda)
    ls = torch.tensor([-0.3, 0.2], device=cuda)
    got = FP.actor_grads_cuda(x, aux, kp, hw, hb, ls, **kw)
    for g, w in zip(_flat(got), _flat(FP.actor_grads_plain(x, aux, kp, hw, hb, ls, **kw))):
        assert _rel(g, w) < 4e-3
    x, aux, params, hw, hb = _unfolded_case(gen, "critic", 600, 4840, hidden, 2, True, False,
                                            True, cuda)
    cb.reset_launches()
    got = _unfolded("critic", x, aux, params, hw, hb, True, **kw)
    assert cb.ENTRY["critic_ppo_grads_unfolded"] == "dcc_critic_grads_unfolded_chunked_mma"
    _assert_unfolded_close(got, _unfolded("critic", x, aux, params, hw, hb, False, **kw), True)
    tkw = dict(n_layers=2, use_fn=True, use_relu=False, bf16=True)
    g = torch.randn(600, hidden, generator=gen).to(cuda).bfloat16()
    cb.reset_launches()
    dx, grads = FM.trunk_backward_cuda(x, params, g, **tkw)
    assert cb.LAUNCHES["fused_mlp_bwd_chunked"] == 1
    want_dx, want = FM.trunk_backward_plain(x, params, g, **tkw)
    for k, p in zip([dx, *grads], [want_dx, *want]):
        assert _rel(k, p) < 4e-3


# Trunks past 8 layers, which the entries once refused (their offsets now a
# device table). Past a few layers the model's trunk carries one bf16
# rounding difference of two summation orders into the later layers'
# outputs and gradients (ROADMAP C8, scripts/depth_spread.py): these checks
# draw the Dense and LN biases from N(0, 1), which damps it, and run relu
# under the relu mask rule (bf16) or with the rows next to a kink given a
# zero cotangent, advantage or valid flag (f32). The bf16 gradient kernels'
# depth layout (every layer's tile in device memory, one in shared memory)
# must give the staged layout's bits on the same tile.
DEEP_KINDS = ("fused_mlp_bwd", "actor", "critic", "actor_unfolded", "critic_unfolded")


def _deep_case(gen, kind, rows, d_in, hidden, n_layers, dev):
    """A trunk of ``n_layers`` layers (biases N(0, 1)), its head, rows and
    the kernel's other operands: (x, aux, params, head_w, head_b)."""
    params = _trunk_params(gen, d_in, hidden, n_layers, True, dev)
    for li in range(n_layers):
        for j in (1, 3):  # the Dense bias, the LN bias
            params[2 + 4 * li + j] = torch.randn(hidden, generator=gen).to(dev)
    n_out = 2 if kind.startswith("actor") else 1
    hw = (0.1 * torch.randn(hidden, n_out, generator=gen)).to(dev)
    hb = (0.1 * torch.randn(n_out, generator=gen)).to(dev)
    x = torch.randn(rows, d_in, generator=gen).to(dev)
    if kind.startswith("actor"):
        aux = FP.pack_actor_aux((0.5 * torch.randn(rows, 2, generator=gen)).to(dev),
                                (-2.0 + 0.3 * torch.randn(rows, 1, generator=gen)).to(dev),
                                torch.randn(rows, 1, generator=gen).to(dev))
    elif kind.startswith("critic"):
        vpred = torch.randn(rows, 1, generator=gen)
        aux = FP.pack_critic_aux(vpred.to(dev), (vpred + 3.0 * torch.randn(rows, 1,
                                                                           generator=gen)).to(dev))
    else:  # K2 / K2b: the cotangent of the trunk output
        aux = torch.randn(rows, hidden, generator=gen).to(dev)
    return x, aux, params, hw, hb


def _deep_call(kind, x, aux, params, hw, hb, n_layers, bf16, on_card=True, relu=True, **m):
    """One K2, K2b, K3, K4, K3u or K4u call as one list of tensors."""
    kw = dict(n_layers=n_layers, use_fn=True, use_relu=relu, bf16=bf16)
    if kind == "fused_mlp":
        fn = FM.trunk_forward_cuda if on_card else FM.trunk_forward_plain
        return [fn(x, params, **kw, **m)]
    if kind == "fused_mlp_bwd":
        fn = FM.trunk_backward_cuda if on_card else FM.trunk_backward_plain
        dx, grads = fn(x, params, aux, **kw, **m)
        return [dx, *grads]
    if kind.endswith("unfolded"):
        return _flat(_unfolded(kind.split("_")[0], x, aux, params, hw, hb, on_card,
                               clip_param=0.2, **kw, **m))
    kp, whf, bhf = FP.fold_trunk(params, hw, hb, n_layers, True)
    if kind == "actor":
        fn = FP.actor_grads_cuda if on_card else FP.actor_grads_plain
        return _flat(fn(x, aux, kp, whf, bhf, torch.tensor([-0.3, 0.2], device=x.device),
                        clip_param=0.2, **kw, **m))
    fn = FP.critic_grads_cuda if on_card else FP.critic_grads_plain
    return _flat(fn(x, aux, torch.tensor([0.5, 2.0], device=x.device), kp, whf, bhf,
                    clip_param=0.2, huber_delta=10.0, use_huber=True, use_clipped=True, **kw,
                    **m))


_DEEP_NAME = {"fused_mlp_bwd": "fused_mlp_bwd", "actor": "actor_ppo_grads",
              "critic": "critic_ppo_grads", "actor_unfolded": "actor_ppo_grads_unfolded",
              "critic_unfolded": "critic_ppo_grads_unfolded"}


# (kind, layers, hidden, row width, rows): every kernel on the default rows,
# the critic's kernels and K2b on the 20-UAV preset's 4,840-wide critic rows;
# on 1,000 rows each takes its smallest tile (16 rows), on 9,000 its largest
# staged one: 64 rows for K2b, K3 and K3u at 110 wide (K3u 32 at hidden 256),
# 32 for the rest, the depth layout's tiles at 32 layers and hidden 256
DEEP_BITS = [(k, L, h, w, r) for L, h, r in ((9, 256, 1000), (32, 128, 1000), (2, 256, 9000),
                                             (7, 128, 9000))
             for k in DEEP_KINDS
             for w in (110, 440, 4840) if w != 4840 or not k.startswith("actor")
             if (L, w) != (32, 440)]


@pytest.mark.parametrize("kind,n_layers,hidden,d_in,rows", DEEP_BITS)
def test_deep_layout_bit_identical_to_staged(cuda, kind, n_layers, hidden, d_in, rows):
    """Each bf16 gradient kernel in its depth layout (the wrappers' ``_deep``)
    against its staged layout on the same rows, tile and inputs: bit for
    bit, relu masks too, at 9 layers and hidden 256 and at 32 layers and
    hidden 128 on 16-row tiles, and at 2 layers and hidden 256 and 7 layers
    and hidden 128 on the largest staged tiles (32 and 64 rows), where the
    staged tiles hold the trunk; 4,840-wide rows in the chunked layouts (the
    critic's kernels and K2b)."""
    from dcc_tpu_torch.ops import tiles

    gen = torch.Generator().manual_seed(n_layers + hidden + d_in)
    x, aux, params, hw, hb = _deep_case(gen, kind, rows, d_in, hidden, n_layers, cuda)
    x = x.bfloat16()
    name = _DEEP_NAME[kind]
    want_plan = tiles.plan(name, True, d_in, hidden, n_layers, 2 if kind.startswith("actor")
                           else 1)
    assert want_plan.tiles and not want_plan.deep
    masks = torch.zeros((n_layers, rows, hidden), dtype=torch.uint8, device=cuda)
    staged = _deep_call(kind, x, aux, params, hw, hb, n_layers, True, relu_masks=masks)
    staged_tile = dict(cb.TILE)
    launched = name + ("_chunked" if name == "fused_mlp_bwd" and want_plan.chunked else "")
    assert staged_tile[launched] == want_plan.tiles[0 if rows > 1000 else -1]
    deep_masks = torch.zeros_like(masks)
    deep = _deep_call(kind, x, aux, params, hw, hb, n_layers, True, relu_masks=deep_masks,
                      _deep=True)
    assert dict(cb.TILE) == staged_tile
    assert all(torch.equal(a, b) for a, b in zip(deep, staged))
    assert torch.equal(masks, deep_masks)


@pytest.mark.parametrize("kind", ("fused_mlp", *DEEP_KINDS))
@pytest.mark.parametrize("n_layers", [8, 9])
@pytest.mark.parametrize("bf16", [False, True])
def test_deep_trunk_kernels_match_plain(cuda, kind, n_layers, bf16):
    """K2, K2b, K3, K4, K3u and K4u at 8 and 9 relu layers (the f32 K2b,
    K3u and K4u read 42 to 45 offsets at 8) against their plain versions:
    f32 within 1e-4 (K2, K2b) and 1e-3, bf16 within 2e-3 (K2) and 4e-3, the
    kernel computed in f32 outside the bf16 bound. bf16 runs under the relu
    mask rule (the kernel's relu masks within one bf16 step of the plain
    version's, which then takes them); K3 and K3u give the rows at the
    clip's kink a zero advantage (``_clip_kink_rows``), K4u the rows whose
    value it rounds apart valid = 0 (``_value_flip_rows``), as the other
    bf16 checks do."""
    _check_against_plain(cuda, kind, n_layers, 256, bf16)


def _check_against_plain(cuda, kind, n_layers, hidden, bf16, d_in=None, **force):
    """``test_deep_trunk_kernels_match_plain``'s check of ``kind`` at
    ``n_layers`` layers of width ``hidden`` on 777 rows, 440 wide for the
    critic's kernels and 110 for the rest unless ``d_in``; ``force``: the
    wrappers' private layout arguments (``_blocked``) of the bf16 calls."""
    d_in = d_in or (440 if kind.startswith("critic") else 110)
    gen = torch.Generator().manual_seed(n_layers + d_in + 13)
    rows, L = 777, n_layers
    x, aux, params, hw, hb = _deep_case(gen, kind, rows, d_in, hidden, L, cuda)
    if bf16:
        x = x.bfloat16()
    folded = kind in ("actor", "critic")
    kp, whf, bhf = FP.fold_trunk(params, hw, hb, L, True)
    if not bf16:  # rows next to a relu kink
        kink = (FP.relu_kink_rows_folded(x, kp, L, True, bf16=False) if folded
                else FM.relu_kink_rows(x, params, L, True, False))
        if kind.startswith("fused_mlp"):
            aux[kink] = 0.0
        else:
            aux[kink, 2 if kind.startswith("critic") else 3] = 0.0
    masks = None
    if bf16:
        masks = torch.zeros((L, rows, hidden), dtype=torch.uint8, device=cuda)
        _deep_call(kind, x, aux, params, hw, hb, L, True, relu_masks=masks, **force)
        if kind == "critic_unfolded":
            flips = _value_flip_rows(x, aux, params, hw, hb, L, True, True, masks=masks)
            assert len(flips) <= 3 + rows // 20
            aux[list(flips), 2] = 0.0
        if kind.startswith("actor"):  # the clip's kink
            ls = torch.tensor([-0.3, 0.2], device=cuda)
            if folded:
                feat = FP._fwd_folded(x, kp, L, True, True, True, masks)[0]
                aux[_clip_kink_rows(feat, aux, whf, bhf, ls), 3] = 0.0
            else:
                feat = FM._forward_chain(x, params, L, True, True, True, masks)[0]
                aux[_clip_kink_rows(feat, aux, hw, hb, ls), 3] = 0.0
        got = _deep_call(kind, x, aux, params, hw, hb, L, True, relu_masks=masks, **force)
        _mask_ok(FP.relu_mask_gap_folded(x, kp, L, True, masks) if folded
                 else FM.relu_mask_gap(x, params, L, True, masks))
    else:
        got = _deep_call(kind, x, aux, params, hw, hb, L, False)
    want = _deep_call(kind, x, aux, params, hw, hb, L, bf16, on_card=False, masks=masks)
    tol = (2e-3 if kind == "fused_mlp" else 4e-3) if bf16 else (
        1e-4 if kind.startswith("fused_mlp") else 1e-3)
    assert max(_rel(g, w) for g, w in zip(got, want)) < tol
    if bf16:
        f32 = _deep_call(kind, x, aux, params, hw, hb, L, False)
        assert max(_rel(g, w) for g, w in zip(f32, want)) > tol


@pytest.mark.parametrize("kind", ("fused_mlp", *DEEP_KINDS))
def test_blocked_kernels_match_plain(cuda, kind):
    """ROADMAP B3 rest: K2, K2b, K3, K4, K3u and K4u in their column-blocked
    layout (``_blocked``: the ``*_blocked`` libraries) at hidden 1,152, two
    relu layers, against their plain versions under the rules of
    ``test_deep_trunk_kernels_match_plain`` (bf16 within 2e-3 for K2, 4e-3
    for the rest, the kernel computed in f32 outside), each launch counted
    under its ``*_blocked`` name."""
    cb.reset_launches()
    _check_against_plain(cuda, kind, 2, 1152, True, _blocked=True)
    name = "fused_mlp" if kind == "fused_mlp" else _DEEP_NAME[kind]
    assert cb.LAUNCHES[f"{name}_blocked"] > 0
    assert cb.ENTRY[f"{name}_blocked"].endswith("_mma")


@pytest.mark.parametrize("kind", ("fused_mlp_bwd", "critic_unfolded"))
def test_blocked_chunked_kernels_match_plain(cuda, kind):
    """K2b and K4u on the 20-UAV preset's 4,840-wide critic rows at hidden
    1,152, where the plan gives them the column-blocked layout's chunked
    kernels unforced, then the layer-0 tail, against their plain versions
    under ``test_blocked_kernels_match_plain``'s rules."""
    from dcc_tpu_torch.ops import tiles

    name = _DEEP_NAME[kind]
    assert tiles.plan(name, True, 4840, 1152, 2, 1).blocked
    cb.reset_launches()
    _check_against_plain(cuda, kind, 2, 1152, True, d_in=4840)
    chunked = "fused_mlp_bwd_chunked" if kind == "fused_mlp_bwd" else name
    assert cb.LAUNCHES[f"{chunked}_blocked"] > 0
    assert "_chunked_mma" in cb.ENTRY[f"{chunked}_blocked"]


def test_blocked_layer0_input_bwd_matches_plain(cuda):
    """The layer-0 input backward's column-blocked build (g0 streamed by the
    products) at hidden 1,152 on 777 rows of 4,840 columns, with dx, against
    its plain version within 1e-4 and bit for bit its staged build (the
    tile it takes otherwise)."""
    gen = torch.Generator().manual_seed(4840 + 1152)
    d_in, hidden, rows = 4840, 1152, 777
    params = _trunk_params(gen, d_in, hidden, 1, True, cuda)
    w0b = FM.pack_mma_weights([params[2]], cuda)[0].view(FM.pad16(d_in), FM.pad16(hidden))
    x = torch.randn(rows, d_in, generator=gen).to(cuda).bfloat16()
    xstats = FM.input_stats(x, True)
    g0 = torch.zeros(rows, FM.pad16(hidden), dtype=torch.bfloat16, device=cuda)
    g0[:, :hidden] = torch.randn(rows, hidden, generator=gen).to(cuda)
    staged = FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, params[0], hidden, True)
    got = FM.layer0_input_bwd_cuda(x, xstats, g0, w0b, params[0], hidden, True, _blocked=True)
    assert cb.ENTRY["layer0_input_bwd_blocked"] == "dcc_layer0_input_bwd_mma"
    assert all(torch.equal(a, b) for a, b in zip(got, staged))
    want = FM.layer0_input_bwd_plain(x, xstats, g0, w0b, params[0], hidden, True)
    assert max(_rel(g, w) for g, w in zip(got, want)) < 1e-4
