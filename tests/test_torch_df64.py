"""The port's double-float arithmetic and compensated pull force against
``dcc_tpu.ops.df64`` and ``dcc_tpu.envs.coverage``.

Each df64 primitive runs on the same f32 inputs (numpy seed) through both
packages. XLA on the CPU contracts ``a * b + c`` into an FMA, so the JAX
side's ``lo`` words may differ from the port's, whose every op rounds once:
the pairs are held by their value, ``hi + lo`` in f64, to 2^-44 relative,
and ``to_f32`` of the pairs bit for bit (measured: every primitive's pair
bit-identical to JAX's but ``sqrt``'s, 2^-47 apart). The error-free
transforms are held exact against f64 on the port's side.

The compensated ``_connect_force``, batched over 256 envs in
``tests/test_compensated.py``'s two regimes (one agent just past the scaled
radius; two pairs just past the unscaled one), against JAX's per env within
2 f32 ulps, against an f64 evaluation of the same f32 positions below
1.5e-7 of the force's scale (``tests/test_compensated.py:137``), and the
plain f32 force at least 10x worse there. The port takes the softplus of
the argument's hi word in f64 (the f32 libraries' exp and log1p differ by
an ulp or two between the CPU and the GPU); measured: 2 ulps from JAX at
most (1 in the pair regime), 5.6e-8 and 5.2e-8 from the truth, where the
plain f32 force reads 2.7e-5 and 1.4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcc_tpu.envs import coverage as jcov
from dcc_tpu.ops import df64 as jdf
from dcc_tpu_torch.configs.loader import load as load_config
from dcc_tpu_torch.envs import coverage as cov
from dcc_tpu_torch.ops import df64
from test_compensated import _f64_connect_force

N = 4096
REL = 2.0 ** -44  # hi + lo agreement with the JAX package


def _pairs(seed):
    """Two (hi, lo) pairs with |lo| <= ulp(hi) / 2 from random doubles, a
    divisor bounded away from 0, and an f32 operand."""
    rng = np.random.default_rng(seed)
    a64 = rng.uniform(-2, 2, N) * 10.0 ** rng.integers(-3, 3, N)
    b64 = rng.uniform(0.1, 2, N) * np.where(rng.random(N) < 0.5, -1.0, 1.0)
    out = []
    for v in (a64, b64):
        hi = v.astype(np.float32)
        out.append((hi, (v - hi.astype(np.float64)).astype(np.float32)))
    return out, rng.uniform(-3, 3, N).astype(np.float32)


def _value(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


OPS = {
    "two_sum": lambda m, x, y, b: m.two_sum(x[0], y[0]),
    "fast_two_sum": lambda m, x, y, b: m.fast_two_sum(y[0] * 1e3, x[0] * 1e-3),
    "two_diff": lambda m, x, y, b: m.two_diff(x[0], y[0]),
    "two_prod": lambda m, x, y, b: m.two_prod(x[0], y[0]),
    "add": lambda m, x, y, b: m.add(x, y),
    "add_f32": lambda m, x, y, b: m.add_f32(x, b),
    "neg": lambda m, x, y, b: m.neg(x),
    "sub": lambda m, x, y, b: m.sub(x, y),
    "mul": lambda m, x, y, b: m.mul(x, y),
    "mul_f32": lambda m, x, y, b: m.mul_f32(x, b),
    "div": lambda m, x, y, b: m.div(x, y),
    "div_f32": lambda m, x, y, b: m.div_f32(x, y[0]),
    "sqrt": lambda m, x, y, b: m.sqrt((abs(x[0]), abs(x[1]) * (x[0] != 0))),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_primitive_matches_jax(op):
    (x, y), b = _pairs(sorted(OPS).index(op))
    if op == "sqrt":  # a non-negative pair, lo's sign following hi's
        x = (x[0], np.where(x[0] < 0, -x[1], x[1]))
    ours = OPS[op](df64, tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y)),
                   torch.from_numpy(b))
    theirs = OPS[op](jdf, tuple(map(jnp.asarray, x)), tuple(map(jnp.asarray, y)),
                     jnp.asarray(b))
    assert ours[0].dtype == ours[1].dtype == torch.float32
    got, want = _value(ours), _value(theirs)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max() <= REL, (op, rel.max())
    np.testing.assert_array_equal(df64.to_f32(ours).numpy(), np.asarray(jdf.to_f32(theirs)))


def test_error_free_transforms_are_exact():
    (x, y), _ = _pairs(99)
    a, c = torch.from_numpy(x[0]), torch.from_numpy(y[0])
    a64, c64 = x[0].astype(np.float64), y[0].astype(np.float64)
    assert np.array_equal(_value(df64.two_sum(a, c)), a64 + c64)
    assert np.array_equal(_value(df64.two_diff(a, c)), a64 - c64)
    assert np.array_equal(_value(df64.two_prod(a, c)), a64 * c64)
    # the double-float ops at about 2^-48 (tests/test_compensated.py's 1e-13)
    xp, yp = tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y))
    ya = (yp[0].abs(), torch.where(yp[0] < 0, -yp[1], yp[1]))  # |y| as a pair
    for got, want in ((df64.mul(xp, yp), _value(x) * _value(y)),
                      (df64.div(xp, yp), _value(x) / _value(y)),
                      (df64.sqrt(ya), np.sqrt(np.abs(_value(y))))):
        assert (np.abs(_value(got) - want) / np.abs(want)).max() < 1e-13


@pytest.mark.parametrize("v", [0.76, 1e-3, 500.0, 1.0 / 3.0])
def test_from_f64_matches_jax(v):
    hi, lo = df64.from_f64(v, device="cpu")
    jhi, jlo = jdf.from_f64(v)
    assert (float(hi), float(lo)) == (float(jhi), float(jlo))
    assert float(hi) + float(lo) == pytest.approx(v, rel=2.0 ** -48)


BASE = dict(n_agents=4, comm_force_scale=5.0, comm_r_scale=0.95)


def regime_positions(case: str, n_envs: int, seed: int) -> np.ndarray:
    """(n_envs, 4, 2) f32 positions in tests/test_compensated.py's force-onset
    regimes: ``isolated`` (a tight cluster and one agent just past the
    scaled radius 0.76) or ``pair`` (two tight pairs just past the unscaled
    radius 0.8: case 2, softplus argument about 40-50)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_envs, 4, 2))
    for e in range(n_envs):
        gap = rng.uniform(1e-4, 0.01)
        theta = rng.uniform(0, 2 * np.pi)
        u = np.array([np.cos(theta), np.sin(theta)])
        if case == "isolated":
            pos[e] = rng.uniform(-0.05, 0.05, (4, 2))
            pos[e, 0] = pos[e, 1] + (2.0 * 0.95 * 0.4 + gap) * u
        else:
            pos[e, 1] = [0.02, 0.0]
            pos[e, 2] = (2.0 * 0.4 + gap) * u
            pos[e, 3] = pos[e, 2] + [0.02, 0.0]
    return pos.astype(np.float32)


def _port_force(cfg, pos):
    dist, _, adj_, _, connect_s = cov.connectivity(cfg, pos)
    return cov._connect_force(cfg, pos, dist, adj_, connect_s), connect_s


@pytest.mark.parametrize("case", ["isolated", "pair"])
def test_compensated_force_matches_jax_and_f64_truth(case):
    cfg = cov.EnvConfig(**BASE, compensated_forces=True)
    pos32 = regime_positions(case, 256, {"isolated": 3, "pair": 4}[case])
    got, connect_s = _port_force(cfg, torch.from_numpy(pos32))
    plain, _ = _port_force(cov.EnvConfig(**BASE), torch.from_numpy(pos32))
    jcfg = jcov.EnvConfig(**BASE, compensated_forces=True)

    def jforce(p):
        dist, _, adj_, _, connect_s = jcov.connectivity(jcfg, p)
        return jcov._connect_force(jcfg, p, dist, adj_, connect_s)

    want = np.asarray(jax.jit(jax.vmap(jforce))(jnp.asarray(pos32)))
    got = got.numpy()
    # within 2 f32 ulps of JAX's force, element by element
    ulp = np.spacing(np.maximum(np.abs(want), np.abs(got)).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()
    errs_c, errs_f = [], []
    for e in range(len(pos32)):
        if bool(connect_s[e]):
            continue
        truth = _f64_connect_force(cfg, pos32[e].astype(np.float64))
        scale = np.abs(truth).max()
        if scale < 1e-6:
            continue
        errs_c.append(np.abs(got[e] - truth).max() / scale)
        errs_f.append(np.abs(plain[e].numpy() - truth).max() / scale)
    assert len(errs_c) >= 16, "degenerate sampling"
    assert max(errs_c) < 1.5e-7, max(errs_c)
    assert max(errs_c) < 0.1 * max(errs_f), (max(errs_c), max(errs_f))


def test_flag_off_is_the_plain_path_and_no_op_in_f64():
    """The flag off steps exactly as a config without it; in an f64 state
    the flag does nothing (the chain is already f64), as in JAX; on an f32
    state it moves the force."""
    pos = torch.from_numpy(regime_positions("isolated", 8, 5))
    act = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 4, 2)).astype(np.float32))
    on = cov.EnvConfig(**BASE, compensated_forces=True)
    off, base = on._replace(compensated_forces=False), cov.EnvConfig(**BASE)

    def stepped(cfg, dtype):
        state = cov.reset(cfg, 8, dtype=dtype, device="cpu")
        state.pos = pos.to(dtype)
        return cov.step(cfg, state, act)[0]

    for dtype in (torch.float32, torch.float64):
        for a, b in ((off, base), (on, base)) if dtype == torch.float64 else ((off, base),):
            sa, sb = stepped(a, dtype), stepped(b, dtype)
            assert torch.equal(sa.pos, sb.pos) and torch.equal(sa.vel, sb.vel)
    assert stepped(on, torch.float32).pos.dtype == torch.float32
    assert not torch.equal(_port_force(on, pos)[0], _port_force(base, pos)[0])


def test_loader_plumbs_compensated_forces():
    _, env_cfg, _ = load_config({"compensated_forces": True})
    assert env_cfg.compensated_forces
    assert not load_config({})[1].compensated_forces
