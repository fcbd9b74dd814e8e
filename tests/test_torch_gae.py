"""GAE: the port's ``compute_gae_cuda`` on CPU tensors (which runs the plain
loop, K1's plain version) and ``compute_gae`` against
``dcc_tpu.ops.compute_gae`` and ``compute_gae_pallas(interpret=True)``, at
the shapes of tests/test_pallas_gae.py. f32 inputs; tolerance 1e-5 as that
file's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.ops import compute_gae as j_gae
from dcc_tpu.ops import compute_gae_pallas as j_gae_pallas
from dcc_tpu.ops.gae import discounted_returns as j_disc
from dcc_tpu_torch.ops import compute_gae, compute_gae_cuda, discounted_returns


def _inputs(T, trailing, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(T,) + trailing).astype(np.float32)
    v = rng.normal(size=(T + 1,) + trailing).astype(np.float32)
    m = (rng.uniform(size=(T + 1,) + trailing) > 0.2).astype(np.float32)
    bm = (rng.uniform(size=(T + 1,) + trailing) > 0.1).astype(np.float32)
    return r, v, m, bm


SHAPES = [(150, (16, 4, 1)), (7, (3, 1)), (33, (130, 5, 1))]


@pytest.mark.parametrize("T,trailing", SHAPES)
def test_kernel_plain_version_matches_pallas_and_scan(T, trailing):
    r, v, m, _ = _inputs(T, trailing)
    ja, jr = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), 0.99, 0.95)
    pa, pr = j_gae_pallas(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), 0.99, 0.95,
                          block_b=128, interpret=True)
    ta, tr = compute_gae_cuda(*map(torch.from_numpy, (r, v, m)), 0.99, 0.95)
    la, lr = compute_gae(*map(torch.from_numpy, (r, v, m)), 0.99, 0.95)
    for got in (ta, la):
        np.testing.assert_allclose(got.numpy(), np.asarray(ja), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(pa), atol=1e-5)
    for got in (tr, lr):
        np.testing.assert_allclose(got.numpy(), np.asarray(jr), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(pr), atol=1e-5)


def test_broadcast_values():
    T = 12
    r = np.ones((T, 8, 4, 1), np.float32)
    v = (np.linspace(0, 1, T + 1).reshape(T + 1, 1, 1, 1) * np.ones((1, 8, 4, 1))).astype(
        np.float32)
    m = np.ones((T + 1, 8, 4, 1), np.float32)
    ja, jr = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), 0.99, 0.95)
    ta, tr = compute_gae_cuda(*map(torch.from_numpy, (r, v, m)), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("T,trailing", SHAPES[:2])
def test_bad_masks_branch(T, trailing):
    r, v, m, bm = _inputs(T, trailing, seed=1)
    ja, jr = j_gae(*map(jnp.asarray, (r, v, m)), 0.99, 0.95, bad_masks=jnp.asarray(bm))
    ta, tr = compute_gae(*map(torch.from_numpy, (r, v, m)), 0.99, 0.95,
                         bad_masks=torch.from_numpy(bm))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


@pytest.mark.parametrize("with_bad_masks", [False, True])
def test_discounted_returns(with_bad_masks):
    r, v, m, bm = _inputs(20, (6, 1), seed=2)
    kw_j, kw_t = {}, {}
    if with_bad_masks:
        kw_j = dict(bad_masks=jnp.asarray(bm), values=jnp.asarray(v[:-1]))
        kw_t = dict(bad_masks=torch.from_numpy(bm), values=torch.from_numpy(v[:-1]))
    want = j_disc(jnp.asarray(r), jnp.asarray(v[-1]), jnp.asarray(m), 0.99, **kw_j)
    got = discounted_returns(torch.from_numpy(r), torch.from_numpy(v[-1]),
                             torch.from_numpy(m), 0.99, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
