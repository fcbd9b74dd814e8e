"""GAE: the port's ``compute_gae_cuda`` on CPU tensors (which runs the plain
loop, K1's plain version) and ``compute_gae`` against
``dcc_tpu.ops.compute_gae`` and ``compute_gae_pallas(interpret=True)``, at
the shapes of tests/test_pallas_gae.py. f32 inputs; tolerance 1e-5 as that
file's. Then K1's segment scheme mirrored in numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.ops import compute_gae as j_gae
from dcc_tpu.ops import compute_gae_pallas as j_gae_pallas
from dcc_tpu.ops.gae import discounted_returns as j_disc
from dcc_tpu_torch.ops import compute_gae, compute_gae_cuda, discounted_returns
from dcc_tpu_torch.ops.cuda_gae import gae_plan, max_block_threads


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


# ---------------------------------------------------------------------------
# K1's segment scheme (csrc/gae.cu), mirrored in numpy f32: the kernel itself
# runs only on the card, so its arithmetic is held here against the JAX
# package, driven by the port's own plan (ops.cuda_gae.gae_plan).


def _segments(T, S, L):
    """(round end t1, segment s, first step, steps) in the kernel's order:
    rounds of S * L steps from the end of time, segments of L steps from the
    round's start; a segment past the round's end has 0 steps."""
    t1 = T
    while t1 > 0:
        t0 = max(t1 - S * L, 0)
        for s in range(S):
            start = t0 + s * L
            yield t1, s, start, max(0, min(start + L, t1) - start)
        t1 -= S * L


def _segment_mirror(r, v, m, gamma, gae_lambda, S, L):
    """Phase 1 folds each segment from a zero carry into (a_s, b_s), phase 2
    passes the carries from the last segment to the first, phase 3 reruns
    each segment from its carry; all columns at once, in f32."""
    f32 = np.float32
    g, gl = f32(gamma), f32(gamma * gae_lambda)
    T, B = r.shape
    adv = np.full((T, B), np.nan, f32)
    ret = np.full((T, B), np.nan, f32)
    rounds = {}
    for t1, s, start, n in _segments(T, S, L):
        rounds.setdefault(t1, []).append((start, n))
    carry_in = np.zeros(B, f32)  # the advantage after the round's last step
    for t1, segs in rounds.items():  # latest round first
        delta, gm, fold = [], [], []
        for start, n in segs:  # phase 1
            sl, nx = slice(start, start + n), slice(start + 1, start + n + 1)
            d = r[sl] + g * v[nx] * m[nx] - v[sl]
            gg = gl * m[nx]
            fa, fb = np.ones(B, f32), np.zeros(B, f32)
            for i in reversed(range(n)):
                fb = d[i] + gg[i] * fb
                fa = fa * gg[i]
            delta.append(d)
            gm.append(gg)
            fold.append((fa, fb))
        carries = [None] * len(segs)
        a = carry_in
        for s in reversed(range(len(segs))):  # phase 2
            carries[s] = a
            a = fold[s][1] + fold[s][0] * a
        for s, (start, n) in enumerate(segs):  # phase 3
            a = carries[s]
            for i in reversed(range(n)):
                a = delta[s][i] + gm[s][i] * a
                adv[start + i] = a
                ret[start + i] = a + v[start + i]
            if s == 0:
                carry_in = a
    return adv, ret


MIRROR_T = (1, 7, 33, 150, 151, 1000)  # 1000: gae_plan's plan walks two rounds
MIRROR_SEGMENTS = (None, 1, 2, 8, 32)  # None: gae_plan's
MIRROR_B = 19


def _plan(T, segments):
    """(S, L): ``gae_plan``'s, or ``segments`` of L = min(32, ceil(T / S))
    steps (empty segments where S > T, rounds where S * L < T)."""
    if segments is None:
        return gae_plan(T, MIRROR_B)[1:3]
    return segments, min(32, -(-T // segments))


def _boundary_inputs(T, seed):
    """(T, B) f32 columns with episode ends (mask 0) at every segment
    boundary of the tested plans (column 1), at the step after it (column
    2) and in runs across it (column 3); column 0 has no episode end, the
    rest random ones."""
    rng = np.random.default_rng(seed)
    B = MIRROR_B
    r = rng.normal(size=(T, B)).astype(np.float32)
    v = rng.normal(size=(T + 1, B)).astype(np.float32)
    m = (rng.uniform(size=(T + 1, B)) > 0.15).astype(np.float32)
    m[:, 0] = 1.0
    m[:, 1:4] = 1.0
    for segments in MIRROR_SEGMENTS:
        for _, s, start, n in _segments(T, *_plan(T, segments)):
            if 0 < start <= T and n:
                m[start, 1] = 0.0
                m[min(start + 1, T), 2] = 0.0
                m[max(start - 1, 1):start + 2, 3] = 0.0
    return r, v, m


@functools.lru_cache(maxsize=None)
def _mirror_case(T):
    r, v, m = _boundary_inputs(T, seed=T)
    ja, jr = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), 0.99, 0.95)
    pa, pr = j_gae_pallas(jnp.asarray(r), jnp.asarray(v), jnp.asarray(m), 0.99, 0.95,
                          block_b=128, interpret=True)
    return (r, v, m), tuple(np.asarray(x) for x in (ja, jr, pa, pr))


@pytest.mark.parametrize("segments", MIRROR_SEGMENTS)
@pytest.mark.parametrize("T", MIRROR_T)
def test_segment_scheme_matches_scan_and_pallas(T, segments):
    (r, v, m), refs = _mirror_case(T)
    adv, ret = _segment_mirror(r, v, m, 0.99, 0.95, *_plan(T, segments))
    tol = 1e-5 * (float(np.abs(refs[0]).max()) + 1.0)  # chip_smoke.py's K1 bound
    for got, want in zip((adv, ret, adv, ret), refs):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("T", (1, 2, 5, 7, 33, 150, 151, 600, 1000, 2000, 5000))
def test_gae_plan_covers_every_step_and_column_once(T):
    for B in (1, 3, 16, 17, 31, 32, 33, 64, 1000, 4096, 16384, 16387):
        W, S, L, blocks = gae_plan(T, B)
        assert 1 <= W <= 32 and 1 <= L <= 32 and 1 <= S <= 32
        assert W * S <= max_block_threads(L)
        steps = np.zeros(T, np.int64)
        for _, _, start, n in _segments(T, S, L):
            steps[start:start + n] += 1
        cols = np.arange(blocks * W)  # block * W + lane
        per_col = np.bincount(cols[cols < B], minlength=B)
        assert (np.outer(steps, per_col) == 1).all(), (T, B)


def test_gae_plan_main_path():
    # 16 envs: one block, 30 segments of 5 steps; 16,384 envs: 512 blocks of
    # 32 columns times 15 segments of 10 steps
    assert gae_plan(150, 16) == (16, 30, 5, 1)
    assert gae_plan(150, 16384) == (32, 15, 10, 512)
