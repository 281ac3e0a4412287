"""The agreement checks of `chip_smoke.py`, on the CPU: the plain versions
stand in for the kernels, which run only on the card.

- `compare_mask` / `compare_rows`: a value that is not finite on the plain
  side marks its env (it once passed unseen and printed a max error of 0),
  the max error is never NaN, a non-finite kernel output raises, and the
  report names the output, its env count, the first env and that env's
  column on both sides;
- `hold` and `repeat_sides`: a disagreement repeats both sides and says
  which one repeated itself;
- `poisoned`: an output element left at its sentinel, a write past an
  output's end, an output not made by the poisoned allocators;
- `guarded`: contiguous views equal to their input, sentinel margins, and
  the plain versions give the same bits through them;
- `repeats`: calls that differ from the first.
"""

import math

import pytest
import torch

import chip_smoke as smoke
from wheeledlab_torch.ops.physics_step import physics_step

torch.set_num_threads(1)

B = 16


@pytest.fixture(scope="module")
def drift_case():
    """One drift step's inputs at B envs and its plain outputs."""
    cfg, x = smoke.step_inputs("mushr", B, seed=3, device="cpu")
    return cfg, x, smoke.plain_step(cfg, x)


def copies(outs):
    return [t.clone() for t in outs]


@pytest.mark.parametrize("value", [math.nan, math.inf, -math.inf])
@pytest.mark.parametrize("output, row, env", [
    ("state", 0, 5), ("obs", 3, 0), ("out", 1, B - 1), ("ep_return", 0, 9)])
def test_plain_side_not_finite_is_flagged(drift_case, value, output, row,
                                          env):
    _, _, want = drift_case
    got, bad_want = copies(want), copies(want)
    i = smoke.STEP_OUTPUTS.index(output)
    got[i][row, (env + 1) % B] += 1e-6    # a max error that NaN would hide
    bad_want[i][row, env] = value
    a = smoke.compare_mask(got, bad_want)
    assert math.isfinite(a.max_err)
    assert a.max_err > 0
    assert a.beyond.nonzero().flatten().tolist() == [env]
    (line,) = a.report
    assert line.startswith(f"{output}: 1 envs beyond tolerance")
    assert f"first env {env}:" in line
    assert "not finite in 0 envs (kernel), 1 (plain)" in line


@pytest.mark.parametrize("value", [math.nan, math.inf])
def test_compare_rows_flags_plain_side_not_finite(value):
    want = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    bad = want.clone()
    bad[2, 1] = value
    a = smoke.compare_rows(want, bad, "state")
    assert a.max_err == 0.0
    assert a.beyond.tolist() == [False, True, False, False]
    assert a.report[0].startswith("state: 1 envs beyond tolerance")


@pytest.mark.parametrize("value", [math.nan, math.inf, -math.inf])
def test_kernel_side_not_finite_raises(drift_case, value):
    _, _, want = drift_case
    got = copies(want)
    got[1][2, 4] = value
    with pytest.raises(AssertionError, match="kernel output not finite"):
        smoke.compare_mask(got, want)
    with pytest.raises(smoke.NotFinite) as e:
        smoke.compare_rows(got[1], want[1], "obs")
    assert e.value.agreement.beyond.nonzero().flatten().tolist() == [4]
    # the helper for callers that report every case first returns it
    a = smoke.agreement(got, want, smoke.STEP_OUTPUTS)
    assert int(a.beyond.sum()) == 1 and math.isfinite(a.max_err)


@pytest.mark.parametrize("output, row, envs, delta", [
    ("step_count", 0, [3, 7], 1),           # an integer that differs
    ("timers", 1, [11], -2),
    ("ep_len", 0, [0, 1, 15], 5),
    ("state", 4, [6, 8], 0.5),              # beyond FLOAT_TOL
    ("out", 0, [2], 0.5)])
def test_report_names_output_env_count_and_first_env(drift_case, output, row,
                                                     envs, delta):
    _, _, want = drift_case
    got = copies(want)
    i = smoke.STEP_OUTPUTS.index(output)
    for e in envs:
        got[i][row, e] += delta
    a = smoke.compare_mask(got, want)
    assert a.beyond.nonzero().flatten().tolist() == envs
    (line,) = a.report
    assert line.startswith(f"{output}: {len(envs)} envs beyond tolerance, "
                           f"{len(envs)} not bit-equal")
    assert f"first env {envs[0]}: kernel {got[i][:, envs[0]].tolist()}, " \
           f"plain {want[i][:, envs[0]].tolist()}" in line


def test_within_tolerance_is_reported_only_when_exact(drift_case):
    _, _, want = drift_case
    got = copies(want)
    got[0][2, 3] += 1e-6
    assert smoke.compare_mask(got, want).report == []
    a = smoke.compare_mask(got, want, exact=True)
    assert int(a.beyond.sum()) == 0 and int(a.differ.sum()) == 1
    assert a.report[0].startswith("state: 0 envs beyond tolerance, 1 not "
                                  "bit-equal; first env 3")


@pytest.mark.parametrize("flaky_side", ["plain", "kernel"])
def test_hold_repeats_both_sides_on_a_disagreement(drift_case, flaky_side,
                                                   capsys):
    cfg, x, _ = drift_case
    calls = []

    def flaky():
        calls.append(1)
        outs = list(smoke.plain_step(cfg, x))
        if len(calls) == 1:
            outs[1] = outs[1].clone()
            outs[1][0, 2] = math.nan          # once, on the first call
        return tuple(outs)

    steady = lambda: smoke.plain_step(cfg, x)
    kernel, plain = ((steady, flaky) if flaky_side == "plain"
                     else (flaky, steady))
    failures = []
    h = smoke.hold("K1 case", kernel, plain, smoke.STEP_OUTPUTS, failures)
    assert h.beyond == 1 and math.isfinite(h.max_err)
    assert failures == ["K1 case: 1 envs beyond tolerance, 1 not bit-equal"]
    assert len(calls) == 2
    out = capsys.readouterr().out
    assert "K1 case obs: 1 envs beyond tolerance" in out
    repeated = {"plain": flaky_side != "plain",
                "kernel": flaky_side != "kernel"}
    assert (f'"kernel_repeated_bit_for_bit": '
            f'{str(repeated["kernel"]).lower()}') in out
    assert (f'"plain_repeated_bit_for_bit": '
            f'{str(repeated["plain"]).lower()}') in out


def test_hold_passes_equal_sides_without_repeating(drift_case, capsys):
    cfg, x, _ = drift_case
    failures = []
    h = smoke.hold("K1 case", lambda: smoke.plain_step(cfg, x),
                   lambda: smoke.plain_step(cfg, x), smoke.STEP_OUTPUTS,
                   failures, exact=True)
    assert (h.beyond, h.differ, h.max_err, failures) == (0, 0, 0.0, [])
    assert "repeat" not in capsys.readouterr().out


def fake_kernel(shape, dtype, unwritten=None, past_end=0):
    """A launch that allocates its output as the wrappers do and writes
    every element but `unwritten`, and `past_end` elements after its end."""
    def launch():
        out = torch.empty(shape, dtype=dtype)
        flat = out.view(-1)
        flat.copy_(torch.arange(flat.numel()).to(dtype))
        if unwritten is not None:
            flat[unwritten] = smoke.sentinel(dtype)
        if past_end:
            end = out.storage_offset() + out.numel()
            out._base[end:end + past_end] = 0
        return out, torch.empty_like(out).fill_(1)
    return launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("unwritten, past_end", [(None, 0), (0, 0), (17, 0),
                                                 (None, 1), (None, 7)])
def test_poisoned_flags_sentinels_left_and_writes_past_the_end(
        dtype, unwritten, past_end):
    shape = (3, 8)
    ordinary = (torch.arange(24).to(dtype).reshape(shape),
                torch.ones(shape, dtype=dtype))
    counts = smoke.poisoned(fake_kernel(shape, dtype, unwritten, past_end),
                            ordinary)
    assert counts == dict(outputs=2, sentinels_left=int(unwritten is not None),
                          margins_written=past_end, not_poisoned=0,
                          not_bit_equal=int(unwritten is not None))


def test_poisoned_allocations_restore_torch_and_fill_with_sentinels():
    empty, empty_like = torch.empty, torch.empty_like
    with smoke.poisoned_allocations() as made:
        f = torch.empty((2, 5))
        i = torch.empty(2, 5, dtype=torch.int32)
        g = torch.empty_like(f)
        keep = torch.empty((4,), dtype=torch.float64)    # no sentinel: as is
    assert (torch.empty, torch.empty_like) == (empty, empty_like)
    assert [m.data_ptr() for m in made] == [f.data_ptr(), i.data_ptr(),
                                           g.data_ptr()]
    assert torch.isnan(f).all() and torch.isnan(g).all()
    assert (i == smoke.INT32_MIN).all()
    assert keep.dtype == torch.float64 and f.is_contiguous()
    for t in made:
        assert t._base.numel() == t.numel() + 2 * t.shape[-1]
        assert smoke.margins_written(t) == 0


def test_poisoned_counts_outputs_it_did_not_make():
    ordinary = torch.zeros(2, 4)
    counts = smoke.poisoned(lambda: torch.zeros(2, 4), ordinary)
    assert counts["not_poisoned"] == 1 and counts["outputs"] == 1


@pytest.mark.parametrize("dtype, shape, margin", [
    (torch.float32, (21, B), B), (torch.int32, (2, B), B),
    (torch.float32, (7,), B), (torch.int32, (1,), 1)])
def test_guarded_views_equal_input_with_sentinel_margins(dtype, shape,
                                                         margin):
    gen = torch.Generator().manual_seed(0)
    t = (torch.randn(shape, generator=gen) * 100).to(dtype)
    g = smoke.guarded(t, margin)
    assert g.is_contiguous() and g.shape == t.shape and g.dtype == dtype
    assert torch.equal(smoke.bits(g), smoke.bits(t))
    buf = g._base
    assert buf.numel() == t.numel() + 2 * margin
    assert g.storage_offset() == margin
    edges = torch.cat([buf[:margin], buf[margin + t.numel():]])
    if dtype == torch.float32:
        assert torch.isnan(edges).all()
    else:
        assert (edges == smoke.INT32_MIN).all()
    assert smoke.margins_written(g) == 0
    buf[-1] = 0
    assert smoke.margins_written(g) == 1


def test_plain_versions_give_the_same_bits_through_guarded_inputs(drift_case):
    cfg, x, want = drift_case
    g = {n: smoke.guarded(v, B) for n, v in x.items()}
    got = smoke.plain_step(cfg, g)
    assert smoke.envs_not_bit_equal(got, want) == 0
    y = smoke.flat_inputs("f1tenth", B, seed=4, device="cpu")
    k = dict(dt=0.005, decimation=4)
    flat = physics_step(**{n: smoke.guarded(v, B) for n, v in y.items()}, **k)
    assert torch.equal(flat, physics_step(**y, **k))
    assert sum(smoke.margins_written(v) for v in g.values()) == 0


@pytest.mark.parametrize("odd_calls, expected", [((), 0), ((2,), 1),
                                                 ((1, 3), 2)])
def test_repeats_counts_calls_unlike_the_first(odd_calls, expected):
    calls = []

    def fn():
        calls.append(1)
        t = torch.zeros(2, 3)
        if len(calls) - 1 in odd_calls:
            t[1, 2] = -0.0                    # the same value, other bits
        return t, torch.zeros(1, 3, dtype=torch.int32)

    assert smoke.repeats(fn, 4) == expected
    assert len(calls) == 4
