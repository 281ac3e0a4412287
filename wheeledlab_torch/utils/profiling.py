"""Wall-clock phase timing — the port of `PhaseTimer` from
`wheeledlab_tpu/utils/profiling.py`."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class PhaseTimer:
    """Accumulates wall-clock per named phase; `summary()` gives totals,
    fractions and per-call means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        out = {}
        for name, t in self.totals.items():
            out[f"time/{name}_s"] = t
            out[f"time/{name}_frac"] = t / total
            if self.counts[name]:
                out[f"time/{name}_mean_ms"] = 1000.0 * t / self.counts[name]
        return out
