"""Per-phase wall-clock timers (the phase-timer half of
:mod:`dcc_tpu.utils.profiling`; device-trace capture is not ported yet).

The caller synchronizes the device inside a phase when it wants device
time rather than enqueue time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple


class PhaseTimer:
    """Accumulates per-phase wall-clock stats (count / total / max)."""

    def __init__(self) -> None:
        self._stats: Dict[str, Tuple[int, float, float]] = {}

    def add(self, name: str, dt: float) -> None:
        n, tot, mx = self._stats.get(name, (0, 0.0, 0.0))
        self._stats[name] = (n + 1, tot + dt, max(mx, dt))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": n, "total_s": tot, "mean_s": tot / n, "max_s": mx}
            for name, (n, tot, mx) in self._stats.items()
        }


__all__ = ["PhaseTimer"]
