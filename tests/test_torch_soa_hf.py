"""Parity of the port's physics kernels' plain versions with the JAX
reference on the CPU: the heightfield substep (`sim/soa_hf.py`), kernel K3's
wrapper (`ops/physics_step_hf.py`) against JAX `pallas_step_hf`, and kernel
K2's wrapper (`ops/physics_step.py`) against JAX `pallas_step`, both Pallas
kernels in interpret mode (the pattern of tests/test_pallas.py and
tests/test_fused_elevation.py). On CPU tensors each wrapper runs its plain
version; the CUDA kernels are held against those on the card by
`chip_smoke.py`. Here the kernels' C interfaces are checked against the
wrappers' ctypes declarations.

Inputs are made with numpy from a seed and handed to both packages: states
over the mounds of the JAX elevation terrain, wheels in and out of contact,
tilted and moving."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.ops.pallas_substep import pallas_step
from wheeledlab_tpu.ops.pallas_substep_hf import pallas_step_hf
from wheeledlab_tpu.sim import soa_hf as jsoa_hf
from wheeledlab_tpu.tasks.elevation.task import (
    ElevationTaskCfg as JElevationTaskCfg,
)
from wheeledlab_tpu.tasks.elevation.task import make_elevation_task as j_task
from wheeledlab_torch.assets.robots import MUSHR_SUS_CFG
from wheeledlab_torch.convert import heightfield_from_jax
from wheeledlab_torch.ops import physics_step as tphys
from wheeledlab_torch.ops import physics_step_hf as tphys_hf
from wheeledlab_torch.sim import soa as tsoa
from wheeledlab_torch.sim import soa_hf as tsoa_hf
from wheeledlab_torch.sim.types import VehicleState, batch_params, with_mass
from wheeledlab_torch.utils.math import matrix_from_quat

from test_torch_soa import dr_params, np_states

torch.set_num_threads(1)

B = 32
DT = 0.01
CSRC = os.path.join(os.path.dirname(tphys.__file__), "..", "csrc")


@pytest.fixture(scope="module")
def terrain():
    """(JAX contact atlas, the port's atlas of the same heightfield)."""
    jt = j_task(JElevationTaskCfg(num_envs=8, terrain_extent=20.0,
                                  num_mounds=10))
    tt = heightfield_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jt.terrain))
    return jt.contact_atlas, tt.build_atlas(p=12, stride=2)


def hf_case(atlas, seed, b=B):
    """numpy inputs of one heightfield step: (state, params, patch, org,
    steer_t, wheel_t), and the terrain constants."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (b,)).astype(np.float32)
    xy = u(-8, 8, b, 2)
    ground = atlas.lookup(torch.from_numpy(xy)).numpy()
    roll, pitch, yaw = u(-0.3, 0.3), u(-0.3, 0.3), u(-np.pi, np.pi)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    state = np.stack([
        xy[:, 0], xy[:, 1], ground + 0.06 + u(-0.03, 0.12),
        cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr,
        u(-3, 3), u(-3, 3), u(-0.5, 0.5), u(-1, 1), u(-1, 1), u(-3, 3),
        *u(-10, 80, 4, b), *u(-0.5, 0.5, 2, b), *u(-2, 2, 2, b),
    ]).astype(np.float32)
    tp = batch_params(MUSHR_SUS_CFG, b)
    tp = with_mass(tp, tp.mass + torch.from_numpy(u(0.2, 0.5)))
    params = tsoa.pack_params(tp, 1.0).numpy()
    patch, org = atlas.extract_rows(torch.from_numpy(state[0]),
                                    torch.from_numpy(state[1]))
    nx, ny = atlas.grid_shape
    consts = dict(p=atlas.p, nx=nx, ny=ny, cell=atlas.cell)
    return (state, params, patch.numpy(), org.numpy(), u(-0.5, 0.5, 2, b),
            u(0, 60, 4, b)), consts


def as_torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


class TestSubstepHf:
    @pytest.mark.parametrize("substeps", [1, 10])
    def test_matches_jax(self, terrain, substeps):
        """`substep_soa_hf` chained. Same float32 operations in the same
        order; the packages' libm sin/cos/tanh differ in the last ulp, and
        the stiff contact amplifies that over 10 substeps: tolerance 1e-5
        relative + 1e-4 absolute (measured max difference 3e-6)."""
        _, atlas = terrain
        arrays, k = hf_case(atlas, 5)
        got = as_torch(arrays)[0]
        t_in = as_torch(arrays)
        for _ in range(substeps):
            got = tsoa_hf.substep_soa_hf(got, *t_in[1:], DT, **k)

        def jax_steps(m, *rest):
            for _ in range(substeps):
                m = jsoa_hf.substep_soa_hf(m, *rest, DT, **k)
            return m

        want = jax.jit(jax_steps)(*map(jnp.asarray, arrays))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    def test_inputs_touch_and_fly(self, terrain):
        """The cases above have wheels in contact and envs in the air."""
        _, atlas = terrain
        (state, params, patch, org, _, _), k = hf_case(atlas, 5)
        s, pp = torch.from_numpy(state), torch.from_numpy(params)
        pen = []
        rot = matrix_from_quat(s[3:7].T)
        for w in range(4):
            # the penetration of substep_soa_hf at the initial state
            arm = rot @ pp[6 + 3 * w:9 + 3 * w].T[..., None]
            c = s[0:3].T + arm[..., 0]
            gh = atlas.lookup(c[:, :2])
            pen.append(gh + pp[5] - c[:, 2])
        touching = (torch.stack(pen) > 0).any(0)
        assert 0 < int(touching.sum()) < B


class TestPhysicsStepHf:
    def test_cpu_wrapper_matches_pallas_interpret(self, terrain):
        """K3's wrapper on CPU tensors (its plain version) against JAX
        `pallas_step_hf` in interpret mode, p = 12, decimation 10, the
        elevation task's constants; tolerance as for the substep (measured
        max difference 1.4e-4, on wheel rates up to 80 rad/s)."""
        _, atlas = terrain
        arrays, k = hf_case(atlas, 6)
        before = tphys_hf.LAUNCHES
        got = tphys_hf.physics_step_hf(*as_torch(arrays), dt=DT,
                                       decimation=10, **k)
        assert tphys_hf.LAUNCHES == before      # no kernel on the CPU
        want = pallas_step_hf(*map(jnp.asarray, arrays), DT, 10,
                              interpret=True, **k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    def test_rejects_bad_inputs(self, terrain):
        _, atlas = terrain
        arrays, k = hf_case(atlas, 7)
        t = as_torch(arrays)
        call = lambda *a, **kw: tphys_hf.physics_step_hf(
            *a, dt=DT, decimation=10, **{**k, **kw})
        with pytest.raises(ValueError, match="patch"):
            call(t[0], t[1], t[2][:-1], *t[3:])
        with pytest.raises(TypeError):
            call(t[0].double(), *t[1:])
        with pytest.raises(ValueError, match="contiguous"):
            call(t[0], t[1], t[2], t[3], t[4].T.contiguous().T, t[5])
        with pytest.raises(ValueError, match="patch side"):
            call(*t[:2], torch.zeros((43 * 43, B)), *t[3:], p=43)


class TestPhysicsStep:
    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    @pytest.mark.parametrize("decimation", [4, 20])
    def test_cpu_wrapper_matches_pallas_interpret(self, robot, decimation):
        """K2's wrapper on CPU tensors (its plain version, the substep_soa
        loop) against JAX `pallas_step` in interpret mode, at the drift
        play variant's decimation 4 and the visual task's 20. Tolerance:
        tests/test_torch_soa.py's, widened to 1e-4 absolute (measured max
        difference 1.3e-4, on wheel rates up to 80 rad/s)."""
        s = np_states(8)
        _, tp = dr_params(robot, 9)
        params = tsoa.pack_params(tp, 1.0).numpy()
        state = tsoa.pack_state(VehicleState(**{
            k: torch.from_numpy(v) for k, v in s.items()})).numpy()
        rng = np.random.default_rng(10)
        steer_t = rng.uniform(-0.5, 0.5, (2, B)).astype(np.float32)
        wheel_t = rng.uniform(0.0, 60.0, (4, B)).astype(np.float32)
        arrays = (state, params, steer_t, wheel_t)
        before = tphys.LAUNCHES
        got = tphys.physics_step(*as_torch(arrays), dt=0.005,
                                 decimation=decimation)
        assert tphys.LAUNCHES == before
        want = pallas_step(*map(jnp.asarray, arrays), 0.005, decimation,
                           interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    def test_rejects_bad_inputs(self):
        z = lambda r: torch.zeros((r, 8))
        with pytest.raises(ValueError, match="steer_t"):
            tphys.physics_step(z(21), z(46), z(3), z(4), dt=0.005,
                               decimation=4)
        with pytest.raises(ValueError, match="params"):
            tphys.physics_step(z(21), torch.zeros((46, 9)), z(2), z(4),
                               dt=0.005, decimation=4)


class TestKernelInterfaces:
    """The ctypes side of the kernels' C interfaces, checked against the
    CUDA sources here (nothing compiles CUDA on the CPU)."""

    def test_hf_struct_mirrors_cuda_struct(self):
        src = open(os.path.join(CSRC, "substep_hf.cuh")).read()
        body = re.search(r"struct HfConsts \{(.*?)\};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        fields = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            ctype, names = decl.split(None, 1)
            fields += [(n.strip(), ctype) for n in names.split(",")]
        ct = {"float": ctypes.c_float, "int": ctypes.c_int}
        mirror = tphys_hf.HfConstsC._fields_
        assert [(n, ct[t]) for n, t in fields] == list(mirror)

    def test_hf_consts_rounded_once(self):
        c = tphys_hf.hf_consts(0.01, 10, 12, 177, 177, 0.25)
        assert c.dt == np.float32(0.01) and c.dt2 == np.float32(0.01 * 0.01)
        assert c.half_dt == np.float32(0.005) and c.half_nx == 88.0
        assert c.uv_max == np.float32(12 - 1.001) and c.p == 12

    @pytest.mark.parametrize("name,n_ptr,lead", [
        ("physics_step", 5, None), ("physics_step_hf", 7, "wl::HfConsts")])
    def test_launchers_take_the_wrappers_arguments(self, name, n_ptr, lead):
        src = open(os.path.join(CSRC, f"{name}.cu")).read()
        sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src,
                        re.S).group(1)
        params = [p.strip() for p in sig.split(",")]
        if lead:
            assert params.pop(0).startswith(lead)
        assert all("*" in p for p in params[:n_ptr])
        assert params[n_ptr] == "int B" and params[-1] == "void* stream"
        extra = params[n_ptr + 1:-1]
        assert extra == ([] if lead else ["float dt", "float dt2",
                                          "float half_dt", "int decimation"])


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
