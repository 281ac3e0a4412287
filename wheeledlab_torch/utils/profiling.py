"""Tracing and profiling hooks — the port of
`wheeledlab_tpu/utils/profiling.py`.

- `PhaseTimer`: named wall-clock phases; a phase given `sync=` waits for
  the card before its clock stops, so device time lands in the right phase.
- `trace`: a `torch.profiler` trace of a block (host and, on a card, device
  activity) written as a Chrome trace.
- `debug_nans(True)`: autograd's anomaly mode, which raises at the backward
  op that produced a NaN — the eager counterpart of JAX's `jax_debug_nans`
  and of the reference's NaN action guard (modified_rsl_rl_runner.py:74-75).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


def wait_for(sync) -> None:
    """Block until `sync` is done: a tensor or a device (its card is
    synchronized; the CPU has nothing pending), or anything with a
    `synchronize()` such as a recorded `torch.cuda.Event` or a stream."""
    if isinstance(sync, (str, torch.device, torch.Tensor)):
        dev = (sync.device if isinstance(sync, torch.Tensor)
               else torch.device(sync))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    else:
        sync.synchronize()


class PhaseTimer:
    """Accumulates wall-clock per named phase; `summary()` gives totals,
    fractions and per-call means."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None
              ) -> Iterator[None]:
        """Time the block as `name`; with `sync` (see `wait_for`) the clock
        stops only once the card has finished it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                wait_for(sync)
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

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with `torch.profiler` (the card's activity too when
    there is one) and write `<log_dir>/trace.json` (chrome://tracing,
    Perfetto). Yields the profiler, whose `key_averages()` sum the ops.
    Warns when a trace taken with a card holds nothing of the card's: one
    H100 smoke run saw the profiler record host activity alone in a
    process that had run other jobs before, a fault not reproduced
    since."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                            for e in prof.events()):
            warnings.warn(f"torch.profiler recorded nothing on the card: "
                          f"{log_dir}/trace.json holds host activity only")


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off for the whole process:
    a backward op that returns a NaN raises, naming the forward op."""
    torch.autograd.set_detect_anomaly(enable)
