"""K2's plain version against ``dcc_tpu.ops.fused_mlp.fused_mlp(interpret=True)``
with a ragged row count, in f32 and bf16, and the port's unfused MLPBase
against the flax MLPBase.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.models.mlp import MLPBase as JMLPBase
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
