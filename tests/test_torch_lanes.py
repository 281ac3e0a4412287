"""The wheel-per-lane grouping of the port's physics kernels
(`wheeledlab_torch/csrc/substep.cuh`), as far as the CPU can check it.

The kernels only run on a GPU (`chip_smoke.py` holds them against their
plain versions there). Here:

- the constants that the heightfield wrapper mirrors from the CUDA sources
  for its shared-memory check (envs per block, patch pitch, bytes for every
  patch side it accepts, the largest side), and the grid every launcher of
  the family uses;
- a numpy emulation of the group's reduction: fetching the four wheels'
  values and adding them in wheel order reproduces the plain version's
  running sums bit for bit, which a pairwise tree does not; and of the
  division that selects around a zero numerator, which gives the division's
  own bits;
- which parameter rows a lane loads, and the shared-memory banks a warp's
  patch reads touch;
- the wrappers at the widths that exercise the grouping's tail (1, 7 and
  1000 envs) on the CPU path: K1, K2 and K3 against the JAX reference
  (the Pallas kernels in interpret mode), K4 and K5a env by env against a
  wider call.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_drift import (
    assert_outputs_match, consts, jax_rows, np_inputs, torch_inputs,
)
from test_torch_soa import dr_params, np_states
from test_torch_soa_hf import as_torch, hf_case
from test_torch_soa_hf import terrain  # noqa: F401  (fixture)
from wheeledlab_tpu.ops.pallas_substep import pallas_step
from wheeledlab_tpu.ops.pallas_substep_hf import pallas_step_hf
from wheeledlab_torch.ops import build
from wheeledlab_torch.ops import multi_step as tms
from wheeledlab_torch.ops import physics_step as tphys
from wheeledlab_torch.ops import physics_step_hf as tphys_hf
from wheeledlab_torch.sim import soa as tsoa
from wheeledlab_torch.sim.types import VehicleState
from wheeledlab_torch.tasks.drift import fused as tfused

torch.set_num_threads(1)

TAIL_WIDTHS = (1, 7, 1000)
# sources whose kernel works an env with 4 lanes
LANE_SOURCES = ("fused_drift", "fused_drift_krng", "multi_step",
                "physics_step", "physics_step_hf", "rng_blocks")


def source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def cuda_constant(src, name):
    """Value of `constexpr int <name> = <expr>;` in `src`, with earlier
    constants of the same header substituted."""
    env = {}
    for n, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        env[n] = eval(expr, {}, dict(env))  # noqa: S307  integer expressions
    return env[name]


class TestGroupingConstants:
    def test_python_mirrors_the_header(self):
        src = source("substep.cuh")
        assert cuda_constant(src, "kLanesPerEnv") == 4
        assert cuda_constant(src, "kWarpEnvs") == 8
        threads = cuda_constant(src, "kBlockThreads")
        assert threads % 32 == 0
        assert cuda_constant(src, "kEnvsPerBlock") == tphys_hf.ENVS_PER_BLOCK
        # the register cap that keeps 16384 envs resident at once
        assert 65536 // (cuda_constant(src, "kMinBlocksPerSm") * threads) == 128

    @pytest.mark.parametrize("b,blocks", [(1, 1), (7, 1), (32, 1), (33, 2),
                                          (1000, 32), (1024, 32),
                                          (16384, 512)])
    def test_blocks_for(self, b, blocks):
        src = source("substep.cuh")
        expr = re.search(r"inline int blocks_for\(int B\) \{\s*return (.*?);",
                         src, re.S).group(1)
        per_block = cuda_constant(src, "kEnvsPerBlock")
        assert eval(expr.replace("/", "//"), {},  # noqa: S307
                    {"B": b, "kEnvsPerBlock": per_block}) == blocks

    @pytest.mark.parametrize("name", LANE_SOURCES)
    def test_kernel_and_launcher_use_the_grouping(self, name):
        src = source(f"{name}.cu")
        assert re.search(r"<<<wl::blocks_for\(B\), wl::kBlockThreads,", src)

    def test_sums_are_in_wheel_order(self):
        """Nothing in the build or the shared headers may reorder or
        approximate: no butterfly shuffles, no fast division, no fast-math
        flag, and no FMA contraction: every kernel is held to its plain
        version bit for bit."""
        for hdr in ("substep.cuh", "substep_hf.cuh", "drift_step.cuh"):
            assert "__shfl_xor" not in source(hdr)
            assert "__fdividef" not in source(hdr)
        assert "use_fast_math" not in " ".join(build.NVCC_FLAGS)
        assert "--fmad=false" in build.NVCC_FLAGS


def lane_param_rows(w):
    """Parameter rows that lane `w` of a group loads, read from the row
    expressions of `load_lane_params`."""
    src = source("substep.cuh")
    enum = {}
    for block in re.findall(r"enum (?:StateRow|ParamRow) \{(.*?)\};", src,
                            re.S):
        for n, v in re.findall(r"(\w+) = (\d+)", block):
            enum[n] = int(v)
    body = re.search(r"void load_lane_params\((.*?)\n\}", src, re.S).group(1)
    return [eval(e, {}, {**enum, "w": w})  # noqa: S307  row expressions
            for e in re.findall(r"params\[\(?([^\]]*?)\)? \* n \+ b\]", body)]


class TestWhoHoldsWhat:
    def test_a_group_loads_every_row_it_needs(self):
        rows = set()
        for w in range(4):
            loads = lane_param_rows(w)
            assert len(loads) == len(set(loads)) == 28
            rows |= set(loads)
        assert rows == set(range(tsoa.NUM_PARAM))

    def test_per_wheel_rows_go_to_their_lane(self):
        shared = set.intersection(*(set(lane_param_rows(w))
                                    for w in range(4)))
        assert len(shared) == 22
        for w in range(4):
            own = set(lane_param_rows(w)) - shared
            assert own == {6 + 3 * w, 7 + 3 * w, 8 + 3 * w, 24 + w, 31 + w,
                           36 + w}


def running_sum(x):
    """The plain version's totals: zeros, then `tot = tot + wheel` for
    wheels 0..3 (`sim/soa.py::substep_soa`), on float32 tensors."""
    tot = torch.zeros_like(x[0])
    for w in range(4):
        tot = tot + x[w]
    return tot


def shuffled_sum(x, order="wheel"):
    """numpy emulation of a group's reduction. `x` is (4, n): lane w of
    group g holds x[w, g]. Each lane fetches all four lanes' values (what
    `__shfl_sync(mask, x, k, 4)` returns for k = 0..3) and adds them in
    wheel order; with `order="tree"` it takes the xor butterfly instead
    (partner 1, then partner 2). Returns (4, n): every lane's result."""
    x = np.asarray(x, np.float32)
    if order == "wheel":
        fetched = [np.broadcast_to(x[k], x.shape) for k in range(4)]
        f32 = np.float32
        return (((f32(0) + fetched[0]) + fetched[1]) + fetched[2]) + fetched[3]
    y = x + x[[1, 0, 3, 2]]
    return y + y[[2, 3, 0, 1]]


class TestGroupReduction:
    @pytest.fixture(scope="class")
    def forces(self):
        """Seeded wheel forces and torques of the sizes a drifting car has:
        (6 totals, 4 wheels, n) float32."""
        rng = np.random.default_rng(4)
        scale = np.array([30, 30, 12, 4, 4, 6], np.float32)[:, None, None]
        return (rng.standard_normal((6, 4, 4096)).astype(np.float32) * scale)

    @pytest.mark.parametrize("total", range(6))
    def test_wheel_order_matches_the_plain_sum_bit_for_bit(self, forces,
                                                           total):
        x = forces[total]
        want = running_sum(torch.from_numpy(x)).numpy()
        got = shuffled_sum(x)
        for lane in range(4):       # all four lanes hold the same bits
            assert np.array_equal(got[lane].view(np.uint32),
                                  want.view(np.uint32))

    def test_a_tree_does_not_always(self, forces):
        differs = 0
        for total in range(6):
            x = forces[total]
            want = running_sum(torch.from_numpy(x)).numpy()
            tree = shuffled_sum(x, order="tree")
            assert np.allclose(tree[0], want, rtol=1e-5, atol=1e-4)
            differs += int((tree[0].view(np.uint32)
                            != want.view(np.uint32)).sum())
        assert differs > 0

    def test_zero_start_is_kept(self):
        """0 + (-0) is +0: the sum starts from the plain version's zeros."""
        x = np.full((4, 3), -0.0, np.float32)
        want = running_sum(torch.from_numpy(x)).numpy()
        got = shuffled_sum(x)[0]
        assert np.array_equal(np.signbit(got), np.signbit(want))
        assert not np.signbit(got).any()


def divz_emulated(x, y):
    """numpy emulation of `substep.cuh::divz`: a zero numerator is replaced
    by 1 for the division and the known quotient selected afterwards."""
    x, y = np.float32(x), np.float32(y)
    with np.errstate(all="ignore"):
        zero = x == 0
        q = np.where(zero, np.float32(1), x) / y
        z = np.where(np.abs(y) > 0, x * np.copysign(np.float32(1), y), x * q)
        return np.where(zero, z, q).astype(np.float32)


class TestZeroNumeratorDivision:
    """`divz` takes the card's division off its slow path for a zero
    numerator; it must give the division's own bits for every operand."""

    SPECIAL = [0.0, -0.0, 1.0, -1.0, 0.6, -7.0, 1e-39, -1e-39, 1e-45, 3e38,
               -3e38, np.inf, -np.inf, np.nan]

    def check(self, x, y):
        with np.errstate(all="ignore"):
            want = (np.float32(x) / np.float32(y)).astype(np.float32)
        got = divz_emulated(x, y)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got.view(np.uint32)[~nan],
                              want.view(np.uint32)[~nan])

    def test_special_operands(self):
        x, y = np.meshgrid(np.array(self.SPECIAL, np.float32),
                           np.array(self.SPECIAL, np.float32))
        self.check(x.ravel(), y.ravel())

    def test_seeded_operands(self):
        rng = np.random.default_rng(8)
        x = rng.standard_normal(20000).astype(np.float32)
        x[rng.random(20000) < 0.3] = 0.0
        x[rng.random(20000) < 0.1] *= np.float32(-1)      # some -0
        y = (rng.standard_normal(20000)
             * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
        self.check(x, y)


class TestPatchLayout:
    @pytest.mark.parametrize("p", range(2, tphys_hf.MAX_P + 1))
    def test_pitch_and_shared_bytes(self, p):
        pitch = tphys_hf.patch_pitch(p)
        assert pitch % 4 == 2 and p <= pitch < p + 4
        expr = re.search(r"int patch_pitch\(int p\) \{\s*return (.*?);",
                         source("substep_hf.cuh"), re.S).group(1)
        assert eval(expr, {}, {"p": p}) == pitch  # noqa: S307
        cu = source("physics_step_hf.cu")
        words = re.search(r"int patch_words\(int p\) \{\s*return (.*?);", cu,
                          re.S).group(1)
        per_block = cuda_constant(source("substep.cuh"), "kEnvsPerBlock")
        assert tphys_hf.shared_bytes(p) == 4 * eval(  # noqa: S307
            words, {}, {"p": p, "patch_pitch": tphys_hf.patch_pitch,
                        "kEnvsPerBlock": per_block})
        limit = eval(re.search(r"kMaxSharedBytes = ([^;]+);",  # noqa: S307
                               cu).group(1))
        assert limit == tphys_hf.MAX_SHARED_BYTES == 227 * 1024
        assert tphys_hf.shared_bytes(p) <= limit

    def test_largest_patch(self):
        """`MAX_P` is the last side that fits; the wrapper refuses the
        next one and a side below 2, before it looks at the device."""
        assert tphys_hf.MAX_P == 42
        assert tphys_hf.shared_bytes(42) == 225792
        assert tphys_hf.shared_bytes(43) > tphys_hf.MAX_SHARED_BYTES
        assert tphys_hf.shared_bytes(30) == 115200      # opts in
        assert tphys_hf.shared_bytes(18) <= 48 * 1024 < tphys_hf.shared_bytes(19)
        assert tphys_hf.shared_bytes(12) == 21504
        z = lambda rows: torch.zeros((rows, 4))
        for p in (1, 43):
            with pytest.raises(ValueError, match="patch side"):
                tphys_hf.physics_step_hf(
                    z(21), z(46), z(p * p), z(2), z(2), z(4), dt=0.01,
                    decimation=1, p=p, nx=160, ny=160, cell=0.25)

    @staticmethod
    def banks(p, cells):
        """Banks that one corner read of a warp touches: env e of the warp,
        lane w on cell cells[e][w]; returns the worst number of different
        addresses on one bank."""
        pitch = tphys_hf.patch_pitch(p)
        per_bank = {}
        for e in range(8):
            for ix, iy in cells[e]:
                word = (ix * pitch + iy) * 8 + e
                per_bank.setdefault(word % 32, set()).add(word)
        return max(len(v) for v in per_bank.values())

    @pytest.mark.parametrize("p", [12, 24, 30, 42])
    def test_wheels_on_a_2x2_block_hit_32_banks(self, p):
        rng = np.random.default_rng(p)
        for _ in range(50):
            cells = []
            for _e in range(8):
                ix, iy = rng.integers(0, p - 2, 2)
                cells.append([(ix, iy), (ix, iy + 1), (ix + 1, iy),
                              (ix + 1, iy + 1)])
            for corner in ((0, 0), (0, 1), (1, 0), (1, 1)):
                moved = [[(x + corner[0], y + corner[1]) for x, y in env]
                         for env in cells]
                assert self.banks(p, moved) == 1

    def test_worst_case_is_four_way(self):
        p = 12
        rng = np.random.default_rng(0)
        worst = 0
        for _ in range(200):
            cells = [[tuple(rng.integers(0, p - 1, 2)) for _w in range(4)]
                     for _e in range(8)]
            worst = max(worst, self.banks(p, cells))
        assert worst <= 4
        # four wheels in a line along x, two cells apart: one residue
        line = [[(0, 0), (2, 0), (4, 0), (6, 0)]] * 8
        assert self.banks(p, line) == 4

    def test_staging_covers_the_patch_once(self):
        """The copy loop of the kernel: lane l copies env l % 8, cells
        iy = l // 8, l // 8 + 4, ... of every ix."""
        for p in (2, 12, 13, 30, 42):
            pitch = tphys_hf.patch_pitch(p)
            seen = {}
            for lane in range(32):
                e = lane % 8
                for ix in range(p):
                    for iy in range(lane // 8, p, 4):
                        word = (ix * pitch + iy) * 8 + e
                        assert word not in seen
                        seen[word] = (ix * p + iy, e)
            assert len(seen) == p * p * 8
            # one of the block's regions, a warp each
            warps = tphys_hf.ENVS_PER_BLOCK // 8
            assert max(seen) < tphys_hf.shared_bytes(p) // 4 // warps


def take(x, n, wide=1000):
    """The first `n` envs of every (rows, `wide`) tensor of `x`."""
    return {k: (v[:, :n].contiguous()
                if isinstance(v, torch.Tensor) and v.dim() == 2
                and v.shape[1] == wide else v)
            for k, v in x.items()}


class TestTailWidths:
    """The widths whose last warp is partly empty or whose group count is no
    multiple of 8, on the CPU path: K1, K2 and K3 agree with the JAX
    reference there (tolerances of the modules' own tests); K4 and K5a
    give env by env what a wider call gives (an env never depends on its
    neighbours, which is what lets a tail group work on a copy of the last
    env)."""

    @pytest.fixture(scope="class")
    def drift(self):
        jc, tc, jtask_cfg = consts(num_envs=1000)
        return jc, tc, np_inputs(jc, jtask_cfg, 1000, seed=3)

    @pytest.mark.parametrize("b", TAIL_WIDTHS)
    def test_fused_drift_step(self, drift, b):
        jc, tc, x = drift
        xb = {k: (np.ascontiguousarray(v[:, :b])
                  if v.ndim == 2 and v.shape[1] == 1000 else v)
              for k, v in x.items()}
        before = tfused.LAUNCHES
        got = tfused.fused_drift_step(cfg=tc, **torch_inputs(xb))
        assert tfused.LAUNCHES == before
        assert all(g.shape[1] == b for g in got)
        assert_outputs_match(got, jax_rows(jc, xb))

    @pytest.mark.parametrize("b", TAIL_WIDTHS)
    def test_fused_drift_step_krng(self, drift, b):
        _, tc, x = drift
        t = {k: v for k, v in take(torch_inputs(x), b).items()
             if k not in ("uniforms", "normals")}
        seed = torch.tensor([11], dtype=torch.int32)
        got = tfused.fused_drift_step_krng(cfg=tc, seed=seed, **t)
        assert [tuple(g.shape) for g in got] == [
            (21, b), (14, b), (15, b), (1, b), (tc.n_push, b), (1, b), (1, b)]
        # a draw depends on (seed, env, draw index) only, not on the width
        wide = {k: v for k, v in take(torch_inputs(x), 1000).items()
                if k not in ("uniforms", "normals")}
        want = tfused.fused_drift_step_krng(cfg=tc, seed=seed, **wide)
        for g, w in zip(got, want):
            assert torch.equal(g, w[:, :b])

    @pytest.mark.parametrize("b", TAIL_WIDTHS)
    def test_multi_step(self, drift, b):
        _, tc, x = drift
        k = 2
        rng = np.random.default_rng(b)
        y = {n: v for n, v in torch_inputs(x).items() if n != "action_rows"}
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        y["actions"] = f32(rng.normal(0, 1, (2 * k, 1000)))
        y["uniforms"] = f32(rng.random((tfused.NUM_UNIFORM * k, 1000)))
        y["normals"] = f32(rng.standard_normal((tfused.OBS_ROWS * k, 1000)))
        wide = tms.multi_step(cfg=tc, k=k, **y)
        got = tms.multi_step(cfg=tc, k=k, **take(y, b))
        for g, w in zip(got, wide):
            assert g.shape == (w.shape[0], b)
            assert torch.equal(g, w[:, :b])

    @pytest.mark.parametrize("b", TAIL_WIDTHS)
    def test_physics_step(self, b):
        """K2's wrapper against JAX `pallas_step` in interpret mode."""
        _, tp = dr_params("mushr", 9, b=b)
        state = tsoa.pack_state(VehicleState(**{
            k: torch.from_numpy(v) for k, v in np_states(8, b=b).items()}))
        rng = np.random.default_rng(10)
        arrays = (state.numpy(), tsoa.pack_params(tp, 1.0).numpy(),
                  rng.uniform(-0.5, 0.5, (2, b)).astype(np.float32),
                  rng.uniform(0.0, 60.0, (4, b)).astype(np.float32))
        before = tphys.LAUNCHES
        got = tphys.physics_step(*as_torch(arrays), dt=0.005, decimation=4)
        assert tphys.LAUNCHES == before and got.shape == (21, b)
        want = pallas_step(*map(jnp.asarray, arrays), 0.005, 4,
                           interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("b", TAIL_WIDTHS)
    def test_physics_step_hf(self, terrain, b):  # noqa: F811
        """K3's wrapper against JAX `pallas_step_hf` in interpret mode, at
        the elevation task's p = 12 and decimation 10. Tolerance: that of
        tests/test_torch_soa_hf.py (1e-5 relative + 1e-4 absolute) on every
        row of every env, but for the four wheel rates of at most 2 % of
        the envs, which may differ by 0.05 rad/s: the packages' sin, cos
        and tanh differ in the last ulp, and where a tire sits at the edge
        of its friction limit the stiff wheel dynamics grow that over the
        substeps (measured at 1000 envs: 15 envs, 0.012 rad/s on rates up
        to 80; none at 1 and 7 envs, where 2 % admits none)."""
        _, atlas = terrain
        arrays, k = hf_case(atlas, 9, b=b)
        before = tphys_hf.LAUNCHES
        got = tphys_hf.physics_step_hf(*as_torch(arrays), dt=0.01,
                                       decimation=10, **k)
        assert tphys_hf.LAUNCHES == before and got.shape == (21, b)
        got = got.numpy()
        want = np.asarray(pallas_step_hf(*map(jnp.asarray, arrays), 0.01, 10,
                                         interpret=True, **k))
        diff = np.abs(got - want)
        beyond = diff > 1e-4 + 1e-5 * np.abs(want)
        wheels = slice(13, 17)
        assert not np.delete(beyond, wheels, axis=0).any()
        assert beyond[wheels].any(0).sum() <= b // 50
        assert diff[wheels].max() < 0.05


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
