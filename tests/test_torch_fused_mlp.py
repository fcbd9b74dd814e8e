"""K2's plain version against ``dcc_tpu.ops.fused_mlp.fused_mlp(interpret=True)``
with a ragged row count, in f32 and bf16, and the port's unfused MLPBase
against the flax MLPBase. K2b's plain version against ``jax.grad`` through
the same interpreted kernel and against the kernel body ``_bwd_kernel``
evaluated op by op (tolerances at those tests), and ``FusedTrunk`` on CPU
tensors.

f32: 1e-5 (summation order). bf16: the port rounds where the JAX chain
(``_forward_chain``) rounds; a summation-order difference can flip one bf16
rounding of an intermediate, which moves an output by about one bf16 step
of its magnitude (LN outputs reach a few units: atol 3e-2). Against the
chain evaluated op by op the mean error must also stay below 1e-3; the
compiled Pallas kernel is held to the atol bound only, because XLA's
compilation of the bf16 tanh chain drops some of the written rounding
points (measured: mean 2.4e-3 between the jitted and the op-by-op chain).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.models.mlp import MLPBase as JMLPBase
from dcc_tpu.ops import fused_mlp as jfm
from dcc_tpu.ops.fused_mlp import _forward_chain as j_forward_chain
from dcc_tpu.ops.fused_mlp import fused_mlp as j_fused_mlp
from dcc_tpu_torch.compat import flax_to_state_dict
from dcc_tpu_torch.models import MLPBase
from dcc_tpu_torch.ops import fused_mlp as FM
from dcc_tpu_torch.ops.fused_mlp import fused_mlp


def _params(d_in, hidden, n_layers, seed=0):
    rng = np.random.default_rng(seed)
    flat = [1.0 + 0.1 * rng.normal(size=d_in), 0.1 * rng.normal(size=d_in)]
    d = d_in
    for _ in range(n_layers):
        flat += [
            rng.normal(size=(d, hidden)) / np.sqrt(d),
            0.1 * rng.normal(size=hidden),
            1.0 + 0.1 * rng.normal(size=hidden),
            0.1 * rng.normal(size=hidden),
        ]
        d = hidden
    return [p.astype(np.float32) for p in flat]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rows,d_in,use_relu", [(50, 110, True), (37, 440, True),
                                                (21, 110, False)])
def test_plain_k2_matches_pallas_interpret(bf16, rows, d_in, use_relu):
    params = _params(d_in, 64, 2)
    x = np.random.default_rng(1).normal(size=(rows, d_in)).astype(np.float32)
    want = j_fused_mlp(jnp.asarray(x), [jnp.asarray(p) for p in params], n_layers=2,
                       use_relu=use_relu, bf16=bf16, block_rows=32, interpret=True)
    got = fused_mlp(torch.from_numpy(x), [torch.from_numpy(p) for p in params],
                    n_layers=2, use_relu=use_relu, bf16=bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(got.shape) == (rows, 64)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if bf16:
        np.testing.assert_allclose(got, want, atol=3e-2)
        p2 = [jnp.asarray(p).reshape(1, -1) if p.ndim == 1 else jnp.asarray(p)
              for p in params]
        chain, _ = j_forward_chain(jnp.asarray(x), p2, 2, True, use_relu, True)
        chain = np.asarray(chain, np.float32)
        np.testing.assert_allclose(got, chain, atol=3e-2)
        assert np.abs(got - chain).mean() < 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_mlpbase_matches_flax(fused):
    x = np.random.default_rng(2).normal(size=(3, 5, 110)).astype(np.float32)
    jm = JMLPBase(hidden_size=32, layer_n=1)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0), x))
    want = jm.apply(jp, x)
    m = MLPBase(110, hidden_size=32, layer_n=1, fused=fused)
    m.load_state_dict(flax_to_state_dict(jp))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_trunk_pack_is_cached_per_parameter_version():
    """The K2 launches take a trunk packed once per parameter version: a
    second forward reuses the buffer, an optimizer step (in place) or a
    copy packs again."""
    m = MLPBase(20, hidden_size=8, layer_n=1, fused=True)
    first = m.packed_params("cpu")
    assert m.packed_params("cpu")[0] is first[0]
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    again = m.packed_params("cpu")
    want = FM.pack_params(m.flat_params(), "cpu")
    assert torch.equal(again[0], want[0]) and again[1] == want[1]
    assert not torch.equal(again[0], first[0])
    twin = copy.deepcopy(m)
    with torch.no_grad():
        for p in twin.parameters():
            p.add_(1.0)
    assert torch.equal(twin.packed_params("cpu")[0],
                       FM.pack_params(twin.flat_params(), "cpu")[0])


class _Ref:
    """Stand-in for a Pallas ref, so that ``_bwd_kernel`` runs eagerly."""

    def __init__(self, v):
        self.v, self.shape, self.dtype = v, v.shape, v.dtype

    def __getitem__(self, idx):
        return self.v

    def __setitem__(self, idx, val):
        self.v = jnp.asarray(val, self.dtype).reshape(self.shape)


def _jax_bwd_eager(monkeypatch, x, g, params, **kw):
    """The Pallas backward body ``_bwd_kernel`` evaluated op by op on one
    block of all rows, so every bf16 rounding point it writes is kept."""
    monkeypatch.setattr(jfm, "pl", SimpleNamespace(
        program_id=lambda axis: 0, when=lambda c: (lambda f: f() if c else None)))
    p2 = [jnp.asarray(p).reshape(1, -1) if p.ndim == 1 else jnp.asarray(p) for p in params]
    outs = [_Ref(jnp.zeros(x.shape, x.dtype))] + [_Ref(jnp.zeros(p.shape, jnp.float32))
                                                  for p in p2]
    jfm._bwd_kernel(_Ref(x), _Ref(jnp.asarray(g)), *[_Ref(p) for p in p2], *outs, **kw)
    return [np.asarray(o.v, np.float32) for o in outs]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got.reshape(want.shape) - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("use_relu,use_fn", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_plain_k2b_matches_jax(monkeypatch, bf16, use_relu, use_fn):
    """f32: 1e-5 against both (measured <= 5e-7). bf16 against the op-by-op
    body: 1e-4 (measured <= 2e-7: both round at the same points), and
    autograd of ``trunk_forward_plain``, which rounds the cotangents where
    the forward rounds its values, must fall outside (measured >= 3e-3).
    bf16 against ``jax.grad`` through the compiled interpreted kernel: relu
    1e-4; tanh 2e-2, because XLA's compilation drops some bf16 roundings of
    the tanh chain (measured 6.4e-3; the same gap as the forward above)."""
    rows, d_in, hidden = 45, 40, 32  # ragged against the 16-row Pallas tile
    params = _params(d_in, hidden, 2, seed=3)[(0 if use_fn else 2):]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(rows, d_in)).astype(np.float32)
    g = rng.normal(size=(rows, hidden)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    tp = [torch.from_numpy(p) for p in params]
    if use_relu:  # rows next to a relu kink may take either side in the two frameworks
        g[FM.relu_kink_rows(tx, tp, 2, use_fn, bf16).numpy()] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    if bf16:  # the cotangent of a bf16 output is bf16
        g = np.asarray(jnp.asarray(g, jnp.bfloat16), np.float32)
    kw = dict(n_layers=2, use_relu=use_relu, bf16=bf16)

    def loss(xx, *pp):
        out = j_fused_mlp(xx, list(pp), use_feature_norm=use_fn, block_rows=16,
                          interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)

    jgrad = jax.grad(loss, argnums=tuple(range(len(params) + 1)))(
        jx, *[jnp.asarray(p) for p in params])
    eager = _jax_bwd_eager(monkeypatch, jx, g, params, use_fn=use_fn, **kw)
    dx, grads = FM.trunk_backward_plain(tx, tp, torch.from_numpy(g), use_fn=use_fn, **kw)
    assert dx.dtype == tx.dtype and len(grads) == len(params)
    got = [dx.float().numpy()] + [t.numpy() for t in grads]
    tol = 1e-4 if bf16 else 1e-5
    for i, (a, e, j) in enumerate(zip(got, eager, jgrad)):
        assert _rel(a, e) < tol, i
        assert _rel(a, j) < (2e-2 if bf16 and not use_relu else tol), i
    if bf16:
        leaves = [t.clone().requires_grad_() for t in tp]
        out = FM.trunk_forward_plain(tx, leaves, 2, use_fn, use_relu, True)
        (out.float() * torch.from_numpy(g)).sum().backward()
        assert max(_rel(t.grad.numpy(), e) for t, e in zip(leaves, eager[1:])) > 1e-3


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_trunk_runs_the_explicit_backward(bf16):
    """On CPU tensors MLPBase(fused=True) differentiates through FusedTrunk,
    whose backward is ``trunk_backward_plain``, and only x and the
    parameters are saved."""
    m = MLPBase(20, hidden_size=16, layer_n=1, bf16=bf16, fused=True)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    x = torch.randn(9, 20, generator=torch.Generator().manual_seed(2))
    g = torch.randn(9, 16, generator=torch.Generator().manual_seed(3))
    out = m(x)
    node = out.grad_fn.next_functions[0][0]  # under the reshape back to (..., H)
    assert node.name() == "FusedTrunkBackward"
    assert len(node.saved_tensors) == 1 + len(m.flat_params())
    (out.float() * g).sum().backward()
    g_in = g.bfloat16().float() if bf16 else g
    _, want = FM.trunk_backward_plain(x, [p.detach() for p in m.flat_params()], g_in,
                                      2, True, True, bf16)
    got = [m.feature_norm.weight.grad, m.feature_norm.bias.grad]
    for i in range(2):
        fc, ln = getattr(m, f"fc{i}"), getattr(m, f"norm{i}")
        got += [fc.weight.grad.t(), fc.bias.grad, ln.weight.grad, ln.bias.grad]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
