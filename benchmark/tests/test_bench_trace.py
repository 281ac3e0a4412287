"""The device trace's reduction: the busy time is a union of intervals,
not a sum of durations; gaps are labelled by the host thread's activity."""

import pytest

from benchmark import tracing


def x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_union_counts_overlap_once():
    assert tracing.union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert tracing.union_length([(0, 10), (2, 3), (4, 8)]) == 10
    assert tracing.union_length([]) == 0


def test_gaps_are_the_uncovered_parts():
    assert tracing.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]
    assert tracing.gaps([(-5, 20)], 0, 10) == []


def test_summary_of_a_window():
    events = [
        x("user_annotation", tracing.WINDOW_LABEL, 100, 100),
        x("user_annotation", "bench.rollout", 100, 60),
        x("cpu_op", "aten::add", 100, 10),
        x("cpu_op", "aten::mul", 130, 5),
        x("kernel", "k_a", 110, 20, tid=7),      # 110-130
        x("kernel", "k_a", 120, 20, tid=8),      # overlaps: 120-140
        x("gpu_memcpy", "copy", 150, 10, tid=7),  # 150-160
        x("kernel", "k_b", 190, 30, tid=7),      # clipped to 190-200
        x("kernel", "outside", 300, 10, tid=7),
    ]
    s = tracing.summarize(events)
    assert abs(s.window_s - 100e-6) < 1e-12
    assert abs(s.busy_s - (30 + 10 + 10) * 1e-6) < 1e-12   # not 20+20+10+30
    assert s.kernels["k_a"][0] == pytest.approx(40e-6)
    assert s.kernels["k_a"][1] == 2
    assert "outside" not in s.kernels
    idle = dict(s.idle_gaps)
    # 100-110 inside aten::add; 140-150 and 160-190 begin after aten::mul,
    # in the rollout span
    assert idle["rollout: aten::add"] == pytest.approx(10e-6)
    assert idle["rollout: host code after aten::mul"] == pytest.approx(40e-6)
    assert abs(sum(idle.values()) - 50e-6) < 1e-12


def test_no_window_or_no_device_work_reads_nothing():
    assert tracing.summarize([x("kernel", "k", 0, 1)]) is None
    assert tracing.summarize(
        [x("user_annotation", tracing.WINDOW_LABEL, 0, 10)]) is None
