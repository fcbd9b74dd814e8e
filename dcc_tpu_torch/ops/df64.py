"""Double-float ("df64") arithmetic: about 48-bit-mantissa math from pairs
of f32 tensors.

The counterpart of :mod:`dcc_tpu.ops.df64`: the Dekker / Knuth error-free
transformations (two-sum, two-product by Veltkamp splitting) and the
double-float operations built from them, on (hi, lo) pairs of f32 tensors
with |lo| <= ulp(hi) / 2. The connectivity pull force runs its distance ->
softplus argument -> penetration chain in them (``compensated_forces``),
since its 1 / contact_margin = 1e3 argument scale amplifies the f32 rounding
of the distance, while the env state stays f32.

The transforms are error-free only if every written ``+``, ``-`` and ``*``
rounds once. So each is its own eager elementwise op here: no
``torch.addcmul``, ``addcdiv`` or ``lerp``, no ``torch.compile`` of these
functions, nothing that fuses a product into a sum. Eager PyTorch runs each
op as its own kernel, so nothing is contracted into an FMA on the GPU
either. Constants are tensors on the inputs' device (:func:`from_f64`): a
CUDA tensor divided by a Python number is multiplied by its reciprocal,
which rounds twice.

The JAX package's functions run under XLA, which on the CPU contracts
``a * b + c`` into an FMA; its ``lo`` words may then differ from these while
``hi + lo`` agrees to about 2^-48 relative.

References (public-domain algorithms): T.J. Dekker, "A floating-point
technique for extending the available precision" (1971); D.E. Knuth, TAOCP
vol. 2 (two-sum); Hida, Li and Bailey's double-double conventions.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

# Veltkamp splitting constant for binary32: 2^ceil(24 / 2) + 1
_SPLIT = 4097.0


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Dekker two-sum, valid where |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_diff(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """s + e == a - b exactly, s = fl(a - b)."""
    s = a - b
    bb = s - a
    e = (a - (s - bb)) - (b + bb)
    return s, e


def _split(a: torch.Tensor) -> Pair:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """p + e == a * b exactly (Dekker's product, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# operations on (hi, lo) pairs


def add(x: Pair, y: Pair) -> Pair:
    """Double-float addition (Bailey's sloppy add: about 2 ulp of the pair)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return fast_two_sum(s, e)


def add_f32(x: Pair, b: torch.Tensor) -> Pair:
    s, e = two_sum(x[0], b)
    return fast_two_sum(s, e + x[1])


def neg(x: Pair) -> Pair:
    return -x[0], -x[1]


def sub(x: Pair, y: Pair) -> Pair:
    return add(x, neg(y))


def mul(x: Pair, y: Pair) -> Pair:
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return fast_two_sum(p, e)


def mul_f32(x: Pair, b: torch.Tensor) -> Pair:
    p, e = two_prod(x[0], b)
    return fast_two_sum(p, e + x[1] * b)


def div(x: Pair, y: Pair) -> Pair:
    """Double-float division: an f32 quotient and one refined correction."""
    q0 = x[0] / y[0]
    r = sub(x, mul_f32(y, q0))  # x - q0 * y in double-float
    q1 = (r[0] + r[1]) / y[0]
    return fast_two_sum(q0, q1)


def div_f32(x: Pair, b: torch.Tensor) -> Pair:
    q0 = x[0] / b
    p, e = two_prod(q0, b)
    r = (x[0] - p) + x[1] - e
    return fast_two_sum(q0, r / b)


def sqrt(x: Pair) -> Pair:
    """Double-float square root: one Newton (Karp) refinement of the f32
    square root. Requires x >= 0; sqrt((0, 0)) = (0, 0) by the guard."""
    s0 = torch.sqrt(x[0])
    pos = s0 > 0
    safe = torch.where(pos, s0, torch.ones_like(s0))
    p, e = two_prod(safe, safe)
    r = (x[0] - p) + x[1] - e  # x - s0^2 in double-float
    corr = torch.where(pos, r / (2.0 * safe), torch.zeros_like(s0))
    return fast_two_sum(s0, corr)


def from_f64(v: float, dtype: torch.dtype = torch.float32, device=None) -> Pair:
    """A Python double as an exact (hi, lo) pair of 0-d tensors on ``device``."""
    hi = torch.tensor(v, dtype=torch.float64).to(dtype)
    lo = torch.tensor(v - float(hi), dtype=torch.float64).to(dtype)
    return hi.to(device), lo.to(device)


def to_f32(x: Pair) -> torch.Tensor:
    return x[0] + x[1]


__all__ = ["Pair", "add", "add_f32", "div", "div_f32", "fast_two_sum", "from_f64", "mul",
           "mul_f32", "neg", "sqrt", "sub", "to_f32", "two_diff", "two_prod", "two_sum"]
