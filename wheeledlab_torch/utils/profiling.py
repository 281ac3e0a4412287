"""Tracing and profiling hooks — the port of
`wheeledlab_tpu/utils/profiling.py`.

- `PhaseTimer`: named wall-clock phases; a phase given `sync=` waits for
  the card before its clock stops, so device time lands in the right phase.
- `trace`: a `torch.profiler` trace of a block (host and, on a card, device
  activity) written as a Chrome trace.
- `debug_nans(True)`: autograd's anomaly mode, which raises at the backward
  op that produced a NaN — the eager counterpart of JAX's `jax_debug_nans`
  and of the reference's NaN action guard (modified_rsl_rl_runner.py:74-75).
- `span(name)` / `spanned(name)`: the program's named phases
  (`<layer>.<phase>`, such as `ppo.rollout` or `env.step`), off until
  `enable_spans(True)`. When on, a span is a `record_function` range in a
  profiler's trace, on the clock of the card's kernels, and its host and
  device time add up by name until `drain()`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

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


# ------------------------------------------------------------------ spans
#
# One switch for the process. Off, `span()` returns the shared `NO_SPAN` and
# `spanned` calls straight through: a flag check is the whole cost. On, a
# span reads the host clock at entry and exit; under a running profiler it
# is a `record_function` range (a "user_annotation" event of the Chrome
# trace); on a CUDA device it records a pair of timing events on the current
# stream, taken from a pool and resolved by `drain()` without a synchronize.
# While the current stream captures a CUDA graph, a span records no events.
# Spans are opened by the thread that drives the learner.

_spans_on = False
_span_device: Optional[torch.device] = None   # set: record CUDA events
_span_stream: Optional[tuple] = None          # (stream key, torch Stream)
# name -> [calls, host seconds, device ms, calls whose device ms are in]
_span_totals: Dict[str, list] = {}
_span_pending: List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]] = []
_span_events: List["torch.cuda.Event"] = []   # the pool


class SpanTotals(NamedTuple):
    """A span's totals since the last `drain()`: its calls, their host
    time, and the device time of the `timed` calls whose events were
    resolved (none on the CPU)."""

    calls: int
    host_ms: float
    device_ms: float
    timed: int


class _NoSpan:
    """The shared context of a span that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _span_event() -> "torch.cuda.Event":
    """A timing event recorded on the span device's current stream. The
    stream's Python object is kept while the stream stays current:
    `torch.cuda.current_stream` builds a new one a call, which costs the
    host more than the event's record."""
    global _span_stream
    key = torch._C._cuda_getCurrentStream(_span_device.index)
    if _span_stream is None or _span_stream[0] != key:
        _span_stream = (key, torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2]))
    e = (_span_events.pop() if _span_events
         else torch.cuda.Event(enable_timing=True))
    e.record(_span_stream[1])
    return e


class _Span:
    __slots__ = ("name", "range", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = (torch.profiler.record_function(self.name)
                      if torch.autograd._profiler_enabled() else None)
        if self.range is not None:
            self.range.__enter__()
        self.start = (_span_event() if _span_device is not None
                      and not torch.cuda.is_current_stream_capturing()
                      else None)
        self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        if self.start is not None:
            _span_pending.append((self.name, self.start, _span_event()))
        if self.range is not None:
            self.range.__exit__(*exc)
        acc = _span_totals.get(self.name)
        if acc is None:
            acc = _span_totals[self.name] = [0, 0.0, 0.0, 0]
        acc[0] += 1
        acc[1] += host
        return False


def span(name: str):
    """The context of the program's phase `name`: `NO_SPAN` while spans are
    off, else a span timing the block (see above)."""
    if not _spans_on:
        return NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _spans_on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable_spans(on: bool = True, device=None) -> None:
    """Turn the process's spans on or off. With `device` a CUDA device,
    spans also time the card with events on its current stream. What was
    recorded stays for `drain()`."""
    global _spans_on, _span_device, _span_stream
    _spans_on = bool(on)
    dev = torch.device(device) if device is not None else None
    if on and dev is not None and dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _span_device = dev
    else:
        _span_device = None
    _span_stream = None


def span_summary(totals: Dict[str, SpanTotals]) -> Dict[str, float]:
    """`drain()`'s totals as log keys: `span/<name>/calls` and the mean
    `span/<name>/host_ms` a call, and `span/<name>/device_ms` a timed call
    where the card was timed."""
    out = {}
    for name, t in totals.items():
        key = f"span/{name}/"
        if t.calls:
            out[key + "calls"] = float(t.calls)
            out[key + "host_ms"] = t.host_ms / t.calls
        if t.timed:
            out[key + "device_ms"] = t.device_ms / t.timed
    return out


def drain() -> Dict[str, SpanTotals]:
    """Each span's totals since the last drain, by name, then reset. Device
    times come from the event pairs whose end the card has passed (a
    query, never a synchronize), so call it where the host has just waited
    for the card, as at a metric read; a pair still pending is resolved
    by a later drain."""
    still = []
    for name, start, end in _span_pending:
        if not end.query():
            still.append((name, start, end))
            continue
        acc = _span_totals.get(name)
        if acc is None:
            acc = _span_totals[name] = [0, 0.0, 0.0, 0]
        acc[2] += start.elapsed_time(end)
        acc[3] += 1
        _span_events.extend((start, end))
    _span_pending[:] = still
    out = {k: SpanTotals(calls=v[0], host_ms=1000.0 * v[1], device_ms=v[2],
                         timed=v[3])
           for k, v in _span_totals.items()}
    _span_totals.clear()
    return out
