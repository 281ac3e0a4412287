"""The K-step resident rollout (`wheeledlab_torch/ops/multi_step.py`, the
port of `scripts/limiter_probe.py::multi_step_pallas`) on the CPU.

The Pallas kernel has no interpret path, so it is run through its plain
reference: K chained JAX `drift_step_rows` calls on rows sliced as the
kernel's body slices them (`limiter_probe.py:60-62`). The port's plain
`multi_step` is held against that chain, and at K = 1 against the port's own
`fused_drift_step`.

The CUDA kernel only runs on a GPU; `chip_smoke.py` holds it against
`multi_step_rows` and against K chained launches of the fused step there."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_fused_drift import consts, np_inputs, torch_inputs
from wheeledlab_tpu.tasks.drift import fused as jfused
from wheeledlab_torch.ops import multi_step as tms
from wheeledlab_torch.tasks.drift import fused as tfused

torch.set_num_threads(1)

OUTPUTS = ("state", "step_count", "timers", "ep_return", "ep_len")
# The float tolerance of one control step, port against reference, of
# tests/test_torch_fused_drift.py (the packages' float32 sin/cos/tanh differ
# in the last ulp and 4 stiff substeps amplify it) also holds K chained
# steps: the largest difference measured over K = 1, 2, 4, 8 at B = 256 is
# 1.5e-4 (mushr, K = 4, a wheel rate), and no integer differs.
RTOL, ATOL = 2e-5, 2e-4

CASES = {"mushr": dict(robot="mushr"), "f1tenth": dict(robot="f1tenth")}


def multi_inputs(case, b, k, seed):
    """(JAX consts, port consts, numpy inputs of `k` chained steps)."""
    jc, tc, jtask_cfg = consts(num_envs=b, **CASES[case])
    x = np_inputs(jc, jtask_cfg, b, seed=seed)
    rng = np.random.default_rng(seed + 1000 * k)
    f32 = lambda a: np.asarray(a, np.float32)
    del x["action_rows"]
    x["actions"] = f32(rng.normal(0, 1, (2 * k, b)))
    x["uniforms"] = f32(rng.random((tfused.NUM_UNIFORM * k, b)))
    x["normals"] = f32(rng.standard_normal((tfused.OBS_ROWS * k, b)))
    return jc, tc, x


@functools.lru_cache(maxsize=None)
def jax_step(case, b):
    """One jitted JAX `drift_step_rows` on the kernel's carry (compiled once
    per robot and chained from Python, whatever K is)."""
    jc = consts(num_envs=b, **CASES[case])[0]

    def f(state, params, a, uni, nrm, w, poses, sc, tm, er, el):
        return jfused.drift_step_rows(
            state, params, a[0], a[1], uni, nrm, lambda j: w[j],
            lambda r, c: poses[r, c], sc, tm, er, el, cfg=jc)

    return jax.jit(f)


def jax_chain(case, x, k):
    """The plain reference of `_multi_kernel`: its loop body, K times, on
    rows sliced as it slices them."""
    step = jax_step(case, x["state"].shape[1])
    s, tm = x["state"], x["timers"]
    sc, er, el = x["step_count"][0], x["ep_return"][0], x["ep_len"][0]
    for i in range(k):
        a = x["actions"][2 * i:2 * i + 2]
        uni = x["uniforms"][i * jfused.NUM_UNIFORM:
                            (i + 1) * jfused.NUM_UNIFORM]
        nrm = x["normals"][i * jfused.OBS_ROWS:(i + 1) * jfused.OBS_ROWS]
        s, _obs, _out, sc, tm, er, el = step(
            s, x["params"], a, uni, nrm, x["weights"], x["poses"], sc, tm,
            er, el)
    return [np.asarray(r) for r in (s, sc[None], tm, er[None], el[None])]


class TestMultiStep:
    @pytest.mark.parametrize("k", [1, 2, 4, 8])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_chained_jax_steps(self, case, k):
        _, tc, x = multi_inputs(case, 256, k, seed=11 + len(case))
        before = tms.LAUNCHES
        got = tms.multi_step(cfg=tc, k=k, **torch_inputs(x))
        assert tms.LAUNCHES == before             # CPU calls launch nothing
        want = jax_chain(case, x, k)
        for name, g, w in zip(OUTPUTS, got, want):
            g = g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if g.dtype == np.int32:
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=name)
        # the chain went through resets: episodes restarted on the way
        assert (want[4] < x["ep_len"] + k).any()

    def test_one_step_is_the_fused_step(self):
        _, tc, x = multi_inputs("mushr", 64, 1, seed=2)
        t = torch_inputs(x)
        got = tms.multi_step(cfg=tc, k=1, **t)
        t["action_rows"] = t.pop("actions")
        step = tfused.fused_drift_step(cfg=tc, **t)
        for g, w in zip(got, (step[0], step[3], step[4], step[5], step[6])):
            assert torch.equal(g, w)

    def test_rejects_bad_inputs(self):
        _, tc, x = multi_inputs("mushr", 8, 2, seed=1)
        t = torch_inputs(x)
        with pytest.raises(ValueError, match="at least 1"):
            tms.multi_step(cfg=tc, k=0, **t)
        with pytest.raises(ValueError, match="action_rows"):
            tms.multi_step(cfg=tc, k=3, **t)      # rows stacked for k = 2
        with pytest.raises(ValueError, match="uniforms"):
            tms.multi_step(cfg=tc, k=2, **{**t, "uniforms": t["uniforms"][:12]})
        with pytest.raises(TypeError):
            tms.multi_step(cfg=tc, k=2, **{**t, "timers": t["timers"].float()})
        with pytest.raises(ValueError, match="meta"):
            tms.multi_step(cfg=tc, k=2,
                           **{**t, "normals": t["normals"].to("meta")})


class TestLimiterProbe:
    def test_probe_rows_on_the_cpu(self, monkeypatch, capsys):
        """The probe end to end on the plain version, cut to one call per
        timed unit and K = 1, 2: one JSON line per K with the reference's
        keys, the device named, and every wrapper call counted."""
        from wheeledlab_torch.scripts import limiter_probe

        monkeypatch.setenv("PROBE_ENVS", "32")
        monkeypatch.setattr(limiter_probe, "CALLS_PER_UNIT", 1)
        monkeypatch.setattr(limiter_probe, "KS", (1, 2))
        calls = []
        real = tms.multi_step
        monkeypatch.setattr(tms, "multi_step",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        rows = limiter_probe.main(["--device", "cpu", "--window", "0.001"])
        assert [r["k"] for r in rows] == [1, 2]
        printed = [json.loads(line) for line in
                   capsys.readouterr().out.splitlines()]
        assert printed == rows
        for r in rows:
            assert {"k", "env_steps_per_s", "us_per_control_step",
                    "num_envs", "timed_iters", "wall_s"} <= set(r)
            assert (r["num_envs"], r["mode"], r["device"]) == (32, "eager",
                                                               "cpu")
            assert r["timed_iters"] >= 4 and r["env_steps_per_s"] > 0
        assert sum(r["launches"] for r in rows) == len(calls)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
