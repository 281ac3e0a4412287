"""A profiled window's device trace reduced by the program's own spans.

The program marks its phases with `wheeledlab_torch.utils.profiling.span`
(`ppo.rollout`, `env.step`, `ppo.minibatch`, ...): under a profiler each
call is a "user_annotation" event on the thread that drives the learner.
`reduce_spans` gives, for each span name, its calls and length in the
window, the launches the host issued inside its intervals, and the time the
card was idle inside them. A launch is a CUDA runtime or driver call that
starts a kernel, a copy or a memset, on any thread of the process (the
autograd engine's backward runs on a thread of its own; the port's kernels
are launched through ctypes), counted by its start time.
`idle_by_innermost` puts each idle stretch of the window down to the
innermost program span open when it happened.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmark.tracing import DEVICE_CATS, WINDOW_LABEL

# the first part of a program span's name (`<layer>.<phase>`)
PROGRAM_LAYERS = ("ppo", "env", "drift", "runner")
LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                    r"GraphLaunch|Memcpy|Memset)")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")


class SpanTrace(NamedTuple):
    calls: int
    span_s: float     # the calls' summed length
    launches: int     # launches that began inside the calls
    idle_s: float     # time inside the calls with nothing on the card


def window_of(events: List[dict]) -> Optional[Tuple[float, float]]:
    """(start, end) of the span `WINDOW_LABEL` in microseconds, or None."""
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW_LABEL):
            return e["ts"], e["ts"] + e["dur"]
    return None


def program_spans(events: List[dict], lo: float = float("-inf"),
                  hi: float = float("inf")) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every program span that begins in [lo, hi]."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].split(".")[0] in PROGRAM_LAYERS
                   and lo <= e["ts"] <= hi),
                  key=lambda s: (s[1], -s[2]))


def launch_times(events: List[dict]) -> List[float]:
    """Start times of the host's launch, copy and memset calls, sorted."""
    return sorted(e["ts"] for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_API_CATS
                  and LAUNCH.match(e.get("name", "")))


def busy_intervals(events: List[dict]) -> List[Tuple[float, float]]:
    """The card's kernel, copy and memset intervals, merged and sorted."""
    out: List[List[float]] = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Busy:
    """Busy time inside any [a, b] by bisection over merged intervals."""

    def __init__(self, merged: List[Tuple[float, float]]):
        self.starts = [a for a, _ in merged]
        self.merged = merged
        self.before = [0.0]
        for a, b in merged:
            self.before.append(self.before[-1] + (b - a))

    def within(self, a: float, b: float) -> float:
        if b <= a:
            return 0.0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        total = self.before[j] - self.before[i]
        s, e = self.merged[i]
        total -= max(0.0, min(a, e) - s)        # the first one's part before a
        s, e = self.merged[j - 1]
        total -= max(0.0, e - max(b, s))        # the last one's part after b
        return total


def reduce_spans(events: List[dict]) -> Dict[str, SpanTrace]:
    """Each program span's calls, length, launches and idle time inside the
    window `WINDOW_LABEL` (the whole trace when it holds none)."""
    lo, hi = window_of(events) or (float("-inf"), float("inf"))
    spans = program_spans(events, lo, hi)
    starts = launch_times(events)
    busy = _Busy(busy_intervals(events))
    acc = collections.defaultdict(lambda: [0, 0.0, 0, 0.0])
    for name, a, b in spans:
        s = acc[name]
        s[0] += 1
        s[1] += (b - a) * 1e-6
        s[2] += (bisect.bisect_right(starts, b)
                 - bisect.bisect_left(starts, a))
        s[3] += ((b - a) - busy.within(a, b)) * 1e-6
    return {k: SpanTrace(*v) for k, v in acc.items()}


def idle_by_innermost(events: List[dict]) -> Dict[str, float]:
    """The window's idle seconds by the innermost program span open at the
    time ("outside spans" where none is). The spans nest, being opened and
    closed by one thread."""
    win = window_of(events)
    spans = program_spans(events, *(win or ()))
    if not spans:
        return {}
    lo, hi = win or (spans[0][1], max(b for _, _, b in spans))
    busy = _Busy(busy_intervals(events))
    idle = collections.defaultdict(float)
    stack: List[Tuple[str, float]] = []
    t = lo

    def advance(until: float):
        nonlocal t
        until = min(until, hi)
        if until > t:
            label = stack[-1][0] if stack else "outside spans"
            idle[label] += ((until - t) - busy.within(t, until)) * 1e-6
            t = until

    for name, a, b in spans:
        while stack and stack[-1][1] <= a:
            advance(stack[-1][1])
            stack.pop()
        advance(a)
        stack.append((name, b))
    while stack:
        advance(stack[-1][1])
        stack.pop()
    advance(hi)
    return dict(idle)


def launches_and_device_events(events: List[dict]) -> Tuple[int, int]:
    """The launches that began in the window and the device events that
    began in it: equal when no launch is lost to a thread or a library."""
    lo, hi = window_of(events) or (float("-inf"), float("inf"))
    starts = launch_times(events)
    n_launch = bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo)
    n_dev = sum(1 for e in events if e.get("ph") == "X"
                and e.get("cat") in DEVICE_CATS and lo <= e["ts"] <= hi)
    return n_launch, n_dev
