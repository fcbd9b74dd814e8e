"""Minimal space descriptors (gym-free); the port's copy of
:mod:`dcc_tpu.envs.spaces`.

The reference exposes gym spaces (``environment.py:43-77``) and a vendored
``MultiDiscrete`` (``multi_discrete.py:9-45``); this framework has no gym
dependency, so these light descriptors carry the same information
(shapes/bounds/sampling) for API parity.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Space:
    def sample(self, rng: np.random.RandomState):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape: Tuple[int, ...] = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), self.shape)
        self.dtype = dtype

    def sample(self, rng):
        low = np.where(np.isfinite(self.low), self.low, -1.0)
        high = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(low, high).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low) and np.all(x <= self.high)
        )

    def __repr__(self):
        return f"Box{self.shape}"


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape: Tuple[int, ...] = ()
        self.dtype = np.int64

    def sample(self, rng):
        return int(rng.randint(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """Vendored-gym-style [low, high] ranges per component
    (multi_discrete.py:9-45)."""

    def __init__(self, array_of_param_array: Sequence[Sequence[int]]):
        arr = np.asarray(array_of_param_array)
        self.low = arr[:, 0].astype(np.int64)
        self.high = arr[:, 1].astype(np.int64)
        self.num_discrete_space = self.low.shape[0]
        self.shape = (self.num_discrete_space,)

    def sample(self, rng):
        return (
            self.low
            + (rng.rand(self.num_discrete_space) * (self.high - self.low + 1)).astype(
                np.int64
            )
        )

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )

    @property
    def n(self):
        return int(np.sum(self.high - self.low + 1))

    def __repr__(self):
        return f"MultiDiscrete({self.num_discrete_space})"


class MultiBinary(Space):
    """n independent {0,1} bits (gym.spaces.MultiBinary analog; the
    reference's ACTLayer Bernoulli branch, ``act.py:30-33``)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape: Tuple[int, ...] = (self.n,)
        self.dtype = np.int64

    def sample(self, rng):
        return (rng.rand(self.n) < 0.5).astype(np.int64)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all((x == 0) | (x == 1)))

    def __repr__(self):
        return f"MultiBinary({self.n})"


class TupleSpace(Space):
    """Heterogeneous composite (gym.spaces.Tuple analog) — the reference's
    mixed Box+Discrete action space (``environment.py:43-77`` builds a list
    of sub-spaces when an agent has both movement and communication
    actions)."""

    def __init__(self, spaces: Sequence[Space]):
        self.spaces: Tuple[Space, ...] = tuple(spaces)
        self.shape = tuple(s.shape for s in self.spaces)

    def sample(self, rng):
        return tuple(s.sample(rng) for s in self.spaces)

    def contains(self, x) -> bool:
        return len(x) == len(self.spaces) and all(
            s.contains(xi) for s, xi in zip(self.spaces, x)
        )

    def __repr__(self):
        return f"TupleSpace({', '.join(map(repr, self.spaces))})"
