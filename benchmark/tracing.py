"""Spans and the device trace of a traced run.

Spans are recorded from the benchmark's side, around calls into the
program's layers: `Spans.wrap` replaces a method on one instance by a
wrapper that records a CUDA event before and after each call (host clock
readings on the CPU) and labels the call for the profiler. The device trace
is a `torch.profiler` Chrome trace of a few steady iterations; `summarize`
reduces its events to the device's busy time (the union of kernel, copy and
memset intervals, not the sum of their durations), time by kernel, and the
idle gaps labelled by what the host was doing in them.
"""

from __future__ import annotations

import collections
import functools
import gzip
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

WINDOW_LABEL = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Timed calls by span name, read once the window has closed."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, list] = collections.defaultdict(list)

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wrap(self, obj, attr: str, name: str):
        """Time every call of `obj.attr` as span `name`."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{name}"):
                start = self._mark()
                out = fn(*args, **kwargs)
                self.marks[name].append((start, self._mark()))
            return out

        setattr(obj, attr, timed)

    def durations_ms(self) -> Dict[str, List[float]]:
        """Each span's call times in ms (synchronizes the card)."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.marks.items()}
        return {k: [1000.0 * (b - a) for a, b in v]
                for k, v in self.marks.items()}


class TraceSummary(NamedTuple):
    window_s: float                       # the traced window
    busy_s: float                         # union of device intervals in it
    kernels: Dict[str, Tuple[float, int]]  # name -> (seconds, launches)
    idle_gaps: List[Tuple[str, float]]    # host label -> idle seconds
    device_events: int


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _label_gaps(gap_list, host: List[dict]) -> Dict[str, float]:
    """Idle seconds by what the host thread was doing when each gap began:
    the innermost `bench.*` span and the innermost operator open at that
    time, else the operator that last ended before it. One sweep over the
    host events (one thread, so properly nested) in time order."""
    idle = collections.defaultdict(float)
    stack, last, j = [], None, 0
    for a, b in sorted(gap_list):
        while j < len(host) and host[j]["ts"] <= a:
            e = host[j]
            while stack and stack[-1][1] <= e["ts"]:
                done = stack.pop()[0]
                if done.get("cat") == "cpu_op":
                    last = done["name"]
            stack.append((e, e["ts"] + e.get("dur", 0)))
            j += 1
        while stack and stack[-1][1] < a:
            done = stack.pop()[0]
            if done.get("cat") == "cpu_op":
                last = done["name"]
        span = next((e["name"][6:] for e, _ in reversed(stack)
                     if e["name"].startswith("bench.")), "outside spans")
        op = next((e["name"] for e, _ in reversed(stack)
                   if e.get("cat") == "cpu_op"), None)
        label = (f"{span}: {op}" if op is not None
                 else f"{span}: host code after {last or 'the start'}")
        idle[label] += (b - a) * 1e-6
    return idle


def summarize(events: List[dict], top: int = 10) -> Optional[TraceSummary]:
    """Reduce Chrome trace events to a `TraceSummary` over the span
    `WINDOW_LABEL`; None when the trace holds no such window or no device
    event in it."""
    window = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW_LABEL]
    if not window:
        return None
    lo = window[0]["ts"]
    hi = lo + window[0]["dur"]
    dev, kernels = [], collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        dev.append((a, b))
        k = kernels[e["name"]]
        k[0] += e["dur"] * 1e-6
        k[1] += 1
    if not dev:
        return None
    tid = window[0].get("tid")
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation")
                   and e.get("tid") == tid and e.get("name") != WINDOW_LABEL
                   and lo <= e["ts"] <= hi),
                  key=lambda e: (e["ts"], -e.get("dur", 0)))
    idle = _label_gaps(gaps(dev, lo, hi), host)
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=union_length(dev) * 1e-6,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top],
        device_events=len(dev))


def profile(fn, out_path: str) -> Optional[TraceSummary]:
    """Run `fn` under `torch.profiler` inside the span `WINDOW_LABEL`,
    closed by a synchronize; write the Chrome trace gzipped to `out_path`
    and return its summary."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            fn()
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    raw = out_path[:-3] if out_path.endswith(".gz") else out_path + ".json"
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as f:
        data = f.read()
    os.remove(raw)
    with gzip.open(out_path, "wb") as f:
        f.write(data)
    return summarize(json.loads(data)["traceEvents"])
