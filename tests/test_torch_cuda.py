"""The CUDA kernels K1-K4 against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture, which
skips when no CUDA device is present (the kernels have no CPU mode), so on a
CPU-only host the whole file skips. On a machine with a card, without JAX
installed (``--noconftest`` skips ``tests/conftest.py``, which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The shapes are small but ragged (row counts that are not a multiple of the
row tile) and cover the options the default model does not use: tanh, no
feature norm, one and three layers, other widths, bf16 input rows. The
tolerances are those of ``chip_smoke.py``: f32 differs by summation order,
bf16 by 1-ulp flips of the bf16 roundings inside the chain.

This module imports no JAX: the JAX comparison of the plain versions is in
the other ``tests/test_torch_*.py`` files.
"""

import pytest
import torch

from dcc_tpu_torch.ops import cuda_build as cb
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops import fused_ppo as FP
from dcc_tpu_torch.ops.cuda_gae import compute_gae_cuda
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


@pytest.mark.parametrize("T,E", [(7, 37), (150, 300)])
def test_gae_kernel_matches_plain(cuda, T, E):
    gen = torch.Generator().manual_seed(T + E)
    r = torch.randn(T, E, 1, generator=gen).to(cuda)
    v = torch.randn(T + 1, E, 1, generator=gen).to(cuda)
    m = (torch.rand(T + 1, E, 1, generator=gen) > 0.05).float().to(cuda)
    cb.reset_launches()
    adv, ret = compute_gae_cuda(r, v, m, 0.99, 0.95)
    assert cb.LAUNCHES["gae"] == 1
    want_adv, want_ret = compute_gae(r, v, m, 0.99, 0.95)
    assert _rel(adv, want_adv) < 1e-5 and _rel(ret, want_ret) < 1e-5


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
    with pytest.raises(RuntimeError, match="K2b"):
        FM.trunk_forward_cuda(torch.zeros(4, 16, device=cuda), trainable, n_layers=1)
    # parameters that do not fit the row width would be read out of bounds
    with pytest.raises(ValueError, match="shapes"):
        FM.trunk_forward_cuda(torch.zeros(4, 17, device=cuda), params, n_layers=1)
    x, aux, kp, hw, hb = _ppo_case(gen, "actor", 8, 16, 32, 1, True, cuda)
    with pytest.raises(ValueError, match="shapes"):
        FP.actor_grads_cuda(x[:, :15].contiguous(), aux, kp, hw, hb,
                            torch.zeros(2, device=cuda), n_layers=1, use_fn=True,
                            use_relu=True, bf16=False, clip_param=0.2)
