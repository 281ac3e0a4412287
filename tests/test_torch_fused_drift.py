"""Parity of the port's fused drift step (`wheeledlab_torch/tasks/drift/
fused.py`) with the JAX reference on the CPU: the plain PyTorch
`drift_step_rows` (the CUDA kernel's oracle) against JAX `drift_step_rows`
with the same uniforms and normals, and the port's wrapper against the
Pallas kernel `fused_drift_pallas` run in interpret mode.

The kernel itself only runs on a GPU; `chip_smoke.py` holds it against
`drift_step_rows` there."""

import ctypes
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from wheeledlab_tpu.sim.soa import pack_params as j_pack_params
from wheeledlab_tpu.tasks.drift import fused as jfused
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_task as j_make_task
from wheeledlab_torch.tasks.drift import fused as tfused
from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_task

torch.set_num_threads(1)

OUTPUTS = ("state", "obs", "out", "step_count", "timers", "ep_return",
           "ep_len")
# Float tolerance of one control step, port vs reference: the packages'
# float32 sin/cos/tanh differ in the last ulp and 4 stiff substeps amplify
# that; measured max difference 1.1e-4 on wheel rates of ~100 rad/s (1e-6
# relative), 3e-5 on the weighted rewards, 3e-6 on the observations.
RTOL, ATOL = 2e-5, 2e-4


def consts(**cfg_kw):
    """(JAX consts, port consts) of the same task config."""
    jcfg = JTaskCfg(**cfg_kw)
    tcfg = DriftTaskCfg(**cfg_kw)
    return (jfused.FusedDriftConsts(jcfg, j_make_task(jcfg).cfg),
            tfused.FusedDriftConsts(tcfg, make_drift_task(tcfg).cfg), jcfg)


def np_inputs(jc, jtask_cfg, b, seed):
    """One step's inputs as numpy, in the wrapper's layout: states all over
    and beyond the track, DR'd params, step counts at the time limit and
    push timers about to fire."""
    rng = np.random.default_rng(seed)
    task = j_make_task(jtask_cfg)
    params = np.asarray(j_pack_params(
        task.init_params(jax.random.PRNGKey(seed), b), 1.0))
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (b,))
    roll, pitch, yaw = u(-0.1, 0.1), u(-0.1, 0.1), u(-math.pi, math.pi)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    state = np.stack([
        u(-2.5, 2.5), u(-2.5, 2.5), 0.06 + u(-0.01, 0.01),
        cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr,
        u(-3, 3), u(-3, 3), u(-0.2, 0.2), u(-0.3, 0.3), u(-0.3, 0.3),
        u(-3, 3), *u(-10, 80, 4, b), *u(-0.5, 0.5, 2, b), *u(-2, 2, 2, b)])
    max_len = jc.max_episode_length
    step_count = rng.integers(0, max_len, b)
    step_count[rng.random(b) < 0.15] = max_len - 1
    n_push = max(len(jc.pushes), 1)
    f32 = lambda x: np.asarray(x, np.float32)
    i32 = lambda x: np.asarray(x, np.int32)
    return dict(
        weights=f32([10.0, -5.0, 40.0, 0.0, 20.0, -50.0, -5000.0]
                    + rng.uniform(0, 20, 7)),
        poses=f32(np.concatenate([rng.uniform(-1, 1, (20, 2)),
                                  np.full((20, 1), 0.06),
                                  rng.uniform(-3, 3, (20, 1))], 1)),
        state=f32(state), params=params,
        action_rows=f32(rng.normal(0, 1, (2, b))),
        uniforms=f32(rng.random((tfused.NUM_UNIFORM, b))),
        normals=f32(rng.standard_normal((tfused.OBS_ROWS, b))),
        step_count=i32(step_count[None]),
        timers=(i32(rng.integers(0, 4, (n_push, b))) if jc.pushes
                else np.zeros((1, b), np.int32)),
        ep_return=f32(rng.normal(0, 10, (1, b))),
        ep_len=i32(step_count[None]),
    )


def jax_rows(jc, x):
    """JAX `drift_step_rows` on (rows, B), in the wrapper's output layout."""
    def f(state, params, act, uni, nrm, w, poses, sc, tm, er, el):
        res = jfused.drift_step_rows(
            state, params, act[0], act[1], uni, nrm, lambda i: w[i],
            lambda i, j: poses[i, j], sc[0], tm, er[0], el[0], cfg=jc)
        nsr, obs, out, sc, tm, er, el = res
        return nsr, obs, out, sc[None], tm, er[None], el[None]

    keys = ("state", "params", "action_rows", "uniforms", "normals",
            "weights", "poses", "step_count", "timers", "ep_return", "ep_len")
    return [np.asarray(r) for r in jax.jit(f)(*(x[k] for k in keys))]


def torch_inputs(x):
    return {k: torch.tensor(v) for k, v in x.items()}


def assert_outputs_match(got, want):
    for name, g, w in zip(OUTPUTS, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


CASES = {
    "mushr_events_noise": dict(robot="mushr"),
    "f1tenth_events_noise": dict(robot="f1tenth"),
    "mushr_no_events_no_noise_no_terminations": dict(
        robot="mushr", events_enabled=False, enable_corruption=False,
        terminations_enabled=False),
}


class TestDriftStepRows:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax(self, case):
        jc, tc, jtask_cfg = consts(num_envs=256, **CASES[case])
        x = np_inputs(jc, jtask_cfg, 256, seed=len(case))
        want = jax_rows(jc, x)
        t = torch_inputs(x)
        got = tfused.drift_step_rows(
            t["state"], t["params"], t["action_rows"][0],
            t["action_rows"][1], t["uniforms"], t["normals"], t["weights"],
            t["poses"], t["step_count"][0], t["timers"], t["ep_return"][0],
            t["ep_len"][0], cfg=tc)
        got = [got[0], got[1], got[2], got[3][None], got[4], got[5][None],
               got[6][None]]
        assert_outputs_match(got, want)
        # the inputs exercise resets, time-outs and (when on) pushes
        done, time_out = want[2][tfused.O_DONE], want[2][tfused.O_TIMEOUT]
        assert 0 < time_out.sum() < done.sum() or not tc.terminations_enabled
        assert time_out.sum() > 0


class TestWrapper:
    def test_cpu_wrapper_matches_pallas_interpret(self):
        """The port's wrapper on CPU tensors (-> drift_step_rows) against
        the Pallas kernel in interpret mode, B=32; CPU calls launch no
        kernel."""
        jc, tc, jtask_cfg = consts(num_envs=32)
        x = np_inputs(jc, jtask_cfg, 32, seed=5)
        weights_pad = np.concatenate([x["weights"], [0.0]]).astype(
            np.float32)[None]
        want = jfused.fused_drift_pallas(
            weights_pad, x["poses"], x["state"], x["params"],
            x["action_rows"], x["uniforms"], x["normals"], x["step_count"],
            x["timers"], x["ep_return"], x["ep_len"], cfg=jc,
            n_push=max(len(jc.pushes), 1), interpret=True)
        before = tfused.LAUNCHES
        got = tfused.fused_drift_step(cfg=tc, **torch_inputs(x))
        assert tfused.LAUNCHES == before
        assert_outputs_match(got, [np.asarray(w) for w in want])

    def test_rejects_bad_inputs(self):
        """dtype, shape, contiguity and device are checked before any
        launch."""
        jc, tc, jtask_cfg = consts(num_envs=8)
        x = torch_inputs(np_inputs(jc, jtask_cfg, 8, seed=1))
        bad = {
            TypeError: dict(step_count=x["step_count"].float()),
            ValueError: dict(state=x["state"][:, :4]),
        }
        for exc, change in bad.items():
            with pytest.raises(exc):
                tfused.fused_drift_step(cfg=tc, **{**x, **change})
        with pytest.raises(ValueError, match="contiguous"):
            tfused.fused_drift_step(
                cfg=tc, **{**x, "state": x["state"].T.contiguous().T})
        with pytest.raises(ValueError, match="meta"):
            tfused.fused_drift_step(
                cfg=tc, **{**x, "params": x["params"].to("meta")})


class TestKernelInterface:
    """The ctypes side of the kernel's C interface, checked against the CUDA
    source here (nothing compiles CUDA on the CPU)."""

    CSRC = os.path.join(os.path.dirname(tfused.__file__), "..", "..", "csrc")
    SRC = os.path.join(CSRC, "fused_drift.cu")
    # the struct lives in the header that the drift kernels share
    STRUCT_SRC = os.path.join(CSRC, "drift_step.cuh")

    def test_ctypes_struct_mirrors_cuda_struct(self):
        src = open(self.STRUCT_SRC).read()
        body = re.search(r"struct FusedDriftConsts \{(.*?)\};", src,
                         re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        consts = {"kMaxPush": tfused.MAX_PUSH, "kObsRows": tfused.OBS_ROWS}
        fields = []
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            ctype, names = decl.split(None, 1)
            for name in names.split(","):
                dims = re.findall(r"\[(\w+)\]", name)
                fields.append((name.split("[")[0].strip(), ctype,
                               tuple(int(consts.get(d, d)) for d in dims)))
        ct = {"float": ctypes.c_float, "int": ctypes.c_int}
        mirror = tfused.FusedDriftConstsC._fields_
        assert [f[0] for f in fields] == [m[0] for m in mirror]
        for (name, ctype, dims), (_, mtype) in zip(fields, mirror):
            want = ct[ctype]
            for d in reversed(dims):
                want = want * d
            assert ctypes.sizeof(mtype) == ctypes.sizeof(want), name
            base = mtype
            while hasattr(base, "_type_") and hasattr(base, "_length_"):
                base = base._type_
            assert base is ct[ctype], name

    def test_launcher_takes_the_wrappers_arguments(self):
        src = open(self.SRC).read()
        sig = re.search(r'extern "C" int fused_drift_launch\((.*?)\)', src,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        # the struct, 11 inputs and 7 outputs, the batch size, the stream
        assert len(params) == 1 + 11 + 7 + 2
        assert params[0].startswith("wl::FusedDriftConsts")
        assert params[-2] == "int B" and params[-1] == "void* stream"
        assert all("*" in p for p in params[1:-2])


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
