"""Parity of the port's per-vehicle physics route with the JAX package on
the CPU: the quaternion helpers (`utils/math.py`), the terrain pieces the
physics reads (`sim/terrain.py`: `Heightfield.normal`, `extract_patch`, both
`grid_scan`s, `TerrainPatch`, `PatchAtlas.extract`), `sim/dynamics.py::step`
against `jax.vmap(dynamics.step)` and against the port's packed-row plain
versions, the env's `use_kernels="off"` route against the JAX env's default
CPU route, the drift term functions and `scripts/physics_bench.py`.

Inputs are made with numpy from a seed and handed to both packages. The
heightfield is the JAX elevation task's at a small size, carried across
with `convert.heightfield_from_jax`.

Tolerances: physics state within 2e-5 + 2e-5 |x| on every env (the
reference's own bound between its formulations, tests/test_pallas.py:97-100)
and contact flags equal. The contact forces of `ContactAux` are differences
of stiff spring and damper terms (k ~ 5e3 N/m, so an ulp of a wheel height
is 4e-5 N) and the XLA reference contracts its products into FMAs where
PyTorch on the CPU rounds each: they are held to 2e-5 + 2e-5 max|x| over the
batch (measured: at most 0.27 of it), not elementwise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.envs.env import StepCtx as JStepCtx
from wheeledlab_tpu.envs.env import WheeledEnv as JWheeledEnv
from wheeledlab_tpu.sim import dynamics as jdyn
from wheeledlab_tpu.sim.terrain import Heightfield as JHeightfield
from wheeledlab_tpu.sim.types import VehicleState as JState
from wheeledlab_tpu.tasks.drift import task as jdrift
from wheeledlab_tpu.tasks.elevation.task import (
    ElevationTaskCfg as JElevationTaskCfg,
)
from wheeledlab_tpu.tasks.elevation.task import make_elevation_env as j_elev
from wheeledlab_tpu.utils import math as jmath
from wheeledlab_torch.assets.robots import MUSHR_SUS_CFG
from wheeledlab_torch.convert import env_state_from_jax, heightfield_from_jax
from wheeledlab_torch.envs.env import StepCtx, WheeledEnv
from wheeledlab_torch.ops.physics_step import physics_step
from wheeledlab_torch.ops.physics_step_hf import physics_step_hf
from wheeledlab_torch.scripts import physics_bench
from wheeledlab_torch.sim import dynamics as tdyn
from wheeledlab_torch.sim.soa import pack_params, pack_state
from wheeledlab_torch.sim.terrain import Heightfield
from wheeledlab_torch.sim.types import VehicleState, batch_params, with_mass
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.drift import task as tdrift
from wheeledlab_torch.tasks.elevation.task import (
    ElevationTaskCfg, make_elevation_env,
)
from wheeledlab_torch.utils import math as tmath

from test_torch_soa import STATE_FIELDS, dr_params, np_states

torch.set_num_threads(1)

B = 32
SMALL = dict(terrain_extent=20.0, num_mounds=10)
PHYS_TOL = dict(rtol=2e-5, atol=2e-5)
FLOAT_TOL = dict(rtol=0.0, atol=1e-6)
# the env route against the JAX env: 10x tighter than test_torch_env.py's
# packed-row-against-per-vehicle tolerances
ENV_POS, ENV_VEL, ENV_REWARD, ENV_OBS = 1e-4, 5e-4, 3e-3, 1e-3


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def terrains():
    """(JAX elevation env at the small size, the port's heightfield, the
    port's contact (p = 12) and scan (p = 24) atlases)."""
    jenv = j_elev(JElevationTaskCfg(num_envs=16, **SMALL))
    th = heightfield_from_jax(to_np(jenv.task.terrain))
    return jenv, th, th.build_atlas(p=12, stride=2), th.build_atlas(
        p=24, stride=6)


def centers(seed, b=B):
    """World centers over the field and past its borders."""
    xy = np.random.default_rng(seed).uniform(-9.5, 9.5, (b, 2))
    xy[:3] = [[-12.0, -12.0], [11.0, 3.0], [0.0, 0.0]]
    return xy.astype(np.float32)


def check(got, want, tol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=name)


# ---------------------------------------------------------------------------
# quaternion helpers
# ---------------------------------------------------------------------------


class TestQuat:
    def quats(self, seed, b=64):
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((b, 4)).astype(np.float32)
        q[:4] *= np.float32([1e-12, 1e-3, 10.0, 1.0])[:, None]
        return q

    def test_identity(self):
        np.testing.assert_array_equal(tmath.quat_identity().numpy(),
                                      np.asarray(jmath.quat_identity()))

    def test_normalize(self):
        q = self.quats(0)
        check(tmath.quat_normalize(torch.from_numpy(q)),
              jmath.quat_normalize(jnp.asarray(q)), FLOAT_TOL, "normalize")

    def test_mul(self):
        a, b = self.quats(1), self.quats(2)
        check(tmath.quat_mul(torch.from_numpy(a), torch.from_numpy(b)),
              jmath.quat_mul(jnp.asarray(a), jnp.asarray(b)), FLOAT_TOL,
              "mul")

    def test_integrate(self):
        q = self.quats(3)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        w = np.random.default_rng(4).uniform(-3, 3, (64, 3)).astype(
            np.float32)
        check(tmath.quat_integrate(torch.from_numpy(q), torch.from_numpy(w),
                                   0.005),
              jmath.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.005),
              FLOAT_TOL, "integrate")


# ---------------------------------------------------------------------------
# terrain
# ---------------------------------------------------------------------------


def wheel_points(xy, seed):
    """(B, 4, 2) query points within a wheel's reach of each center."""
    rng = np.random.default_rng(seed)
    return (xy[:, None, :] + rng.uniform(-0.6, 0.6, (len(xy), 4, 2))).astype(
        np.float32)


class TestTerrain:
    def test_normal_matches_jax(self, terrains):
        jenv, th, _, _ = terrains
        pts = wheel_points(centers(0), 1)
        check(th.normal(torch.from_numpy(pts)),
              jenv.task.terrain.normal(jnp.asarray(pts)), FLOAT_TOL,
              "normal")

    @pytest.mark.parametrize("source", ["extract_patch", "atlas"])
    def test_patch_matches_jax(self, terrains, source):
        """The same windows (origins equal, heights bit for bit), and the
        same bilinear heights and normals at each env's wheels."""
        jenv, th, tatlas, _ = terrains
        xy = centers(2)
        if source == "atlas":
            jp = jax.vmap(jenv.task.contact_atlas.extract)(jnp.asarray(xy))
            tp = tatlas.extract(torch.from_numpy(xy))
        else:
            jp = jax.vmap(lambda c: jenv.task.terrain.extract_patch(c, 12))(
                jnp.asarray(xy))
            tp = th.extract_patch(torch.from_numpy(xy), 12)
        np.testing.assert_array_equal(tp.sx.numpy(), np.asarray(jp.sx))
        np.testing.assert_array_equal(tp.sy.numpy(), np.asarray(jp.sy))
        np.testing.assert_array_equal(tp.height.numpy(),
                                      np.asarray(jp.height))
        assert tp.grid_shape == tuple(jp.grid_shape)
        pts = wheel_points(xy, 3)
        jh, jn = jax.vmap(lambda p, q: p.lookup_and_normal(q))(
            jp, jnp.asarray(pts))
        h, n = tp.lookup_and_normal(torch.from_numpy(pts))
        check(h, jh, FLOAT_TOL, "height")
        check(n, jn, FLOAT_TOL, "normal")

    def test_grid_scans_match_jax(self, terrains):
        """The yaw-aligned 26 x 26 scan from the full grid and from each
        env's p = 24 atlas patch."""
        jenv, th, _, tscan = terrains
        xy = centers(4) * np.float32(0.7)
        yaw = np.random.default_rng(5).uniform(-np.pi, np.pi, B).astype(
            np.float32)
        jt, txy, tyaw = jenv.task.terrain, torch.from_numpy(xy), \
            torch.from_numpy(yaw)
        want = jt.grid_scan(jnp.asarray(xy), jnp.asarray(yaw), 2.5, 0.1)
        got = th.grid_scan(txy, tyaw, 2.5, 0.1)
        assert got.shape == (B, 26 * 26)
        check(got, want, FLOAT_TOL, "grid scan")
        jp = jax.vmap(jenv.task.terrain_atlas.extract)(jnp.asarray(xy))
        want = jax.vmap(lambda p, c, y: p.grid_scan(c, y, 2.5, 0.1))(
            jp, jnp.asarray(xy), jnp.asarray(yaw))
        check(tscan.extract(txy).grid_scan(txy, tyaw, 2.5, 0.1), want,
              FLOAT_TOL, "patch grid scan")


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------


def targets(seed, b=B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (b, 2)).astype(np.float32),
            rng.uniform(0.0, 60.0, (b, 4)).astype(np.float32))


def terrain_case(th, seed, b=B):
    """States over the mounds: tilted, moving, wheels in and out of
    contact, some airborne; MuSHR params with DR'd mass."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (b,)).astype(np.float32)
    xy = u(-8, 8, b, 2)
    ground = th.lookup(torch.from_numpy(xy)).numpy()
    quat = tmath.quat_from_euler_xyz(*(torch.from_numpy(a) for a in (
        u(-0.3, 0.3), u(-0.3, 0.3), u(-np.pi, np.pi)))).numpy()
    state = dict(
        pos=np.stack([xy[:, 0], xy[:, 1], ground + 0.06 + u(-0.03, 0.12)],
                     -1),
        quat=quat,
        lin_vel=np.stack([u(-3, 3), u(-3, 3), u(-0.5, 0.5)], -1),
        ang_vel=np.stack([u(-1, 1), u(-1, 1), u(-3, 3)], -1),
        wheel_omega=u(-10, 80, b, 4), steer_pos=u(-0.5, 0.5, b, 2),
        steer_vel=u(-2, 2, b, 2))
    return {k: v.astype(np.float32) for k, v in state.items()}, u(0.2, 0.5)


def elev_params(mass_add, b=B):
    """(JAX params, port params) of the elevation robot with DR'd mass."""
    from wheeledlab_tpu.assets import MUSHR_SUS_CFG as J_MUSHR
    from wheeledlab_tpu.sim.types import batch_params as j_batch
    from wheeledlab_tpu.sim.types import with_mass as j_with_mass

    jp = j_batch(J_MUSHR, b)
    jp = j_with_mass(jp, jp.mass + jnp.asarray(mass_add))
    tp = batch_params(MUSHR_SUS_CFG, b)
    return jp, with_mass(tp, tp.mass + torch.from_numpy(mass_add))


def jax_step(state, jp, terrain, steer, wheel, dt, dec, atlas=None):
    return jax.jit(jax.vmap(jdyn.step,
                            in_axes=(0, 0, None, 0, 0, None, None, None)),
                   static_argnums=(5, 6))(
        JState(**{k: jnp.asarray(v) for k, v in state.items()}), jp, terrain,
        jnp.asarray(steer), jnp.asarray(wheel), dt, dec, atlas)


def port_state(state):
    return VehicleState(**{k: torch.from_numpy(v) for k, v in state.items()})


def check_step(got, aux, want, waux, where):
    for name in STATE_FIELDS:
        check(getattr(got, name), getattr(want, name), PHYS_TOL,
              f"{where} {name}")
    np.testing.assert_array_equal(aux.contact.numpy(),
                                  np.asarray(waux.contact))
    for name in ("normal_force", "long_force", "lat_force"):
        w = np.asarray(getattr(waux, name))
        atol = 2e-5 + 2e-5 * np.abs(w).max()
        check(getattr(aux, name), w, dict(rtol=0.0, atol=atol),
              f"{where} {name}")


class TestDynamics:
    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    def test_flat_matches_jax(self, robot):
        s = np_states(0)
        jp, tp = dr_params(robot, 1)
        steer, wheel = targets(2)
        want, waux = jax_step(s, jp, JHeightfield.flat(), steer, wheel,
                              0.005, 4)
        got, aux = tdyn.step(port_state(s), tp, Heightfield.flat(),
                             torch.from_numpy(steer),
                             torch.from_numpy(wheel), 0.005, 4)
        assert aux.normal_force.shape == (B, 4)
        check_step(got, aux, want, waux, robot)

    @pytest.mark.parametrize("contact", ["atlas", "grid"])
    def test_terrain_matches_jax(self, terrains, contact):
        """Decimation 10 over the mounds, through each env's p = 12 atlas
        patch (TerrainPatch) or on the full grid (no atlas)."""
        jenv, th, tatlas, _ = terrains
        s, mass_add = terrain_case(th, 6)
        jp, tp = elev_params(mass_add)
        steer, wheel = targets(7)
        jatlas = jenv.task.contact_atlas if contact == "atlas" else None
        want, waux = jax_step(s, jp, jenv.task.terrain, steer, wheel, 0.005,
                              10, jatlas)
        got, aux = tdyn.step(port_state(s), tp, th, torch.from_numpy(steer),
                             torch.from_numpy(wheel), 0.005, 10,
                             tatlas if contact == "atlas" else None)
        flags = aux.contact.numpy()
        assert flags.any() and not flags.all(), "wheels in and out of contact"
        assert (~flags).all(-1).any(), "an airborne car"
        check_step(got, aux, want, waux, contact)

    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    def test_flat_matches_packed_rows(self, robot):
        """The port's per-vehicle step against its packed-row one (K2's
        plain version) on the same states: bit for bit, since this module
        takes the packed-row order where the two formulations differ."""
        s = np_states(3)
        _, tp = dr_params(robot, 4)
        steer, wheel = (torch.from_numpy(a) for a in targets(5))
        got, _ = tdyn.step(port_state(s), tp, Heightfield.flat(), steer,
                           wheel, 0.005, 4)
        rows = physics_step(pack_state(port_state(s)), pack_params(tp, 1.0),
                            steer.T.contiguous(), wheel.T.contiguous(),
                            dt=0.005, decimation=4)
        np.testing.assert_array_equal(pack_state(got).numpy(), rows.numpy())

    @pytest.mark.parametrize("contact", ["atlas", "grid"])
    def test_terrain_matches_packed_rows(self, terrains, contact):
        """The per-vehicle step, through the p = 12 atlas or on the full
        grid, against K3's plain version fed the atlas patches: bit for bit
        (the grid's bilinear sample and normal are the patch's
        expressions)."""
        _, th, tatlas, _ = terrains
        s, mass_add = terrain_case(th, 8)
        _, tp = elev_params(mass_add)
        steer, wheel = (torch.from_numpy(a) for a in targets(9))
        got, _ = tdyn.step(port_state(s), tp, th, steer, wheel, 0.005, 10,
                           tatlas if contact == "atlas" else None)
        mem = pack_state(port_state(s))
        patch, org = tatlas.extract_rows(mem[0], mem[1])
        nx, ny = tatlas.grid_shape
        rows = physics_step_hf(mem, pack_params(tp, 1.0), patch, org,
                               steer.T.contiguous(), wheel.T.contiguous(),
                               dt=0.005, decimation=10, p=12, nx=nx, ny=ny,
                               cell=tatlas.cell)
        np.testing.assert_array_equal(pack_state(got).numpy(), rows.numpy())


# ---------------------------------------------------------------------------
# the env's per-vehicle route
# ---------------------------------------------------------------------------


def actions(t, n):
    return np.stack([np.full((n,), 0.6, np.float32),
                     np.full((n,), 0.4 * np.sin(0.7 * t), np.float32)], -1)


def env_pair(case, n=B):
    """(JAX env on its default CPU route, the port's env at
    use_kernels="off")."""
    if case.startswith("drift"):
        kw = dict(num_envs=n, robot=case.split("-")[1],
                  events_enabled=False, enable_corruption=False)
        jenv = jdrift.make_drift_env(jdrift.DriftTaskCfg(**kw))
        tenv = make_env("MushrDriftRL-v0", device="cpu", overrides=kw,
                        use_kernels="off")
        return jenv, tenv
    cfg = dict(num_envs=n, events_enabled=False, **SMALL)
    jenv = j_elev(JElevationTaskCfg(**cfg))
    tenv = make_elevation_env(
        ElevationTaskCfg(**cfg), device="cpu",
        terrain=heightfield_from_jax(to_np(jenv.task.terrain)))
    if case == "elevation-no-atlas":
        drop = dict(terrain_atlas=None, contact_atlas=None)
        return (JWheeledEnv(jenv.task._replace(**drop)),
                WheeledEnv(tenv.task._replace(**drop), device="cpu"))
    return jenv, WheeledEnv(tenv.task._replace(
        cfg=tenv.task.cfg.replace(use_kernels="off")), device="cpu")


class TestOffRoute:
    @pytest.mark.parametrize("case", ["drift-mushr", "drift-f1tenth",
                                      "elevation", "elevation-no-atlas"])
    def test_eight_steps_match_jax(self, case):
        jenv, tenv = env_pair(case)
        assert tenv.per_vehicle and not jenv._use_pallas
        js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
        ts = env_state_from_jax(to_np(js))
        jstep = jax.jit(jenv.step)
        alive = np.ones((B,), bool)
        for t in range(8):
            a = actions(t, B)
            js, jout = jstep(js, jnp.asarray(a))
            ts, tout = tenv.step(ts, torch.from_numpy(a))
            assert isinstance(ts.vehicle_mem, VehicleState)
            assert sorted(tout.info) == sorted(jout.info)
            flags = [("done", tout.done, jout.done)] + [
                (k, tout.info[k], jout.info[k]) for k in jout.info
                if k.startswith("done/")]
            for name, got, want in flags:
                np.testing.assert_array_equal(
                    got.numpy()[alive], np.asarray(want)[alive],
                    err_msg=f"{name} step {t}")
            for name, got, want in [("reward", tout.reward, jout.reward)] + [
                    (k, tout.info[k], jout.info[k]) for k in jout.info
                    if not k.startswith("done/")]:
                np.testing.assert_allclose(
                    got.numpy().astype(np.float32)[alive],
                    np.asarray(want, np.float32)[alive], rtol=0,
                    atol=ENV_REWARD, err_msg=f"{name} step {t}")
            alive &= ~np.asarray(jout.done)
            jv, tv = js.vehicle, ts.vehicle
            for name, got, want, atol in (
                    ("pos", tv.pos, jv.pos, ENV_POS),
                    ("lin_vel", tv.lin_vel, jv.lin_vel, ENV_VEL),
                    ("obs", tout.obs, jout.obs, ENV_OBS)):
                np.testing.assert_allclose(
                    got.numpy()[alive], np.asarray(want)[alive], rtol=0,
                    atol=atol, err_msg=f"{name} step {t}")
            np.testing.assert_array_equal(ts.step_count.numpy()[alive],
                                          np.asarray(js.step_count)[alive])
        assert alive.sum() >= B // 2, "too many resets for a parity check"

    def test_ctx_aux_by_route(self):
        """StepCtx.aux holds the last substep's ContactAux on the
        per-vehicle route and None on the kernel routes."""
        seen = {}
        for route in ("off", "auto"):
            env = make_env("MushrDriftRL-v0", num_envs=8, play=True,
                           device="cpu", use_kernels=route)

            def record(ctx, route=route):
                seen[route] = ctx.aux
                return torch.zeros(ctx.vehicle.pos.shape[0])

            env.task = env.task._replace(metric_fns={"aux": record})
            s, _ = env.reset()
            env.step(s, torch.zeros((8, 2)))
        assert isinstance(seen["off"], tdyn.ContactAux)
        assert seen["off"].normal_force.shape == (8, 4)
        assert seen["auto"] is None

    def test_heightfield_without_atlas_builds_and_steps(self, terrains):
        _, th, _, _ = terrains
        env = make_elevation_env(ElevationTaskCfg(num_envs=8, **SMALL),
                                 device="cpu", terrain=th)
        env = WheeledEnv(env.task._replace(terrain_atlas=None,
                                           contact_atlas=None), device="cpu")
        assert env.per_vehicle
        s, obs = env.reset()
        for _ in range(3):
            s, out = env.step(s, torch.full((8, 2), 0.5))
        assert torch.isfinite(out.obs).all() and obs.shape == out.obs.shape

    def test_bad_setting_raises(self):
        with pytest.raises(ValueError, match="use_kernels"):
            make_env("MushrDriftRL-v0", num_envs=8, device="cpu",
                     use_kernels="maybe")

    def test_trains_and_resumes_exactly(self, tmp_path):
        """Training on the per-vehicle route checkpoints its VehicleState
        carry and VehicleParams (as dicts of tensors) and resumes exactly:
        2 iterations + 1 resumed equal 3 straight."""
        from test_torch_train import read_metrics, tiny_cfg
        from wheeledlab_torch.rl.runner import train

        def run(name, iterations, **extra):
            env = make_env("MushrDriftRL-v0", num_envs=16, device="cpu",
                           use_kernels="off")
            state, _ = train(tiny_cfg(tmp_path, name, iterations, **extra),
                             env=env, verbose=False)
            assert isinstance(state.env_state.vehicle_mem, VehicleState)

        run("off1", 2)
        run("off2", 3, **{"train.load_run": "off1"})
        run("off3", 3)
        resumed = read_metrics(tmp_path, "off2")
        straight = read_metrics(tmp_path, "off3")[-1]
        assert [r["iteration"] for r in resumed] == [3]
        for k in ("loss/total", "lr", "rollout/reward_mean", "metrics/speed"):
            assert resumed[0][k] == straight[k], k

    def test_checkpoint_dict_round_trip(self):
        env = make_env("MushrDriftRL-v0", num_envs=8, device="cpu",
                       use_kernels="off")
        s, _ = env.reset()
        d = s.to_dict()
        assert isinstance(d["vehicle_mem"], dict)
        back = type(s).from_dict(d)
        for name in STATE_FIELDS:
            assert torch.equal(getattr(back.vehicle, name),
                               getattr(s.vehicle, name))
        assert torch.equal(back.params.mass, s.params.mass)


# ---------------------------------------------------------------------------
# drift terms
# ---------------------------------------------------------------------------


TERMS = ("track_progress_rate", "vel_dist", "cross_track_dist",
         "energy_through_turn", "side_slip", "turn_left_go_right",
         "term_pens")


def drift_ctxs(seed, b=64):
    """One context in each package: positions over the oval and off it,
    body velocities with slip below, inside and above the thresholds."""
    rng = np.random.default_rng(seed)
    s = np_states(seed, b)
    s["pos"][:, :2] = rng.uniform(-2.5, 2.5, (b, 2))
    s["ang_vel"][:, 2] = rng.uniform(-2, 2, b)
    lin = np.stack([rng.uniform(-3, 3, b), rng.uniform(-2, 2, b),
                    rng.uniform(-0.2, 0.2, b)], -1).astype(np.float32)
    ang = rng.uniform(-2, 2, (b, 3)).astype(np.float32)
    oob = rng.random(b) < 0.3
    jctx = JStepCtx(
        vehicle=JState(**{k: jnp.asarray(v) for k, v in s.items()}),
        params=None, terrain=None, body_lin_vel=jnp.asarray(lin),
        body_ang_vel=jnp.asarray(ang), last_action=None, prev_vehicle=None,
        command=None, step_count=None, common_step=None, terminated=None,
        time_out=None, term_flags={"out_of_bounds": jnp.asarray(oob)},
        aux=None)
    tctx = StepCtx(
        vehicle=port_state(s), params=None, terrain=None,
        body_lin_vel=torch.from_numpy(lin), body_ang_vel=torch.from_numpy(ang),
        last_action=None, prev_vehicle=None, command=None, step_count=None,
        common_step=0, term_flags={"out_of_bounds": torch.from_numpy(oob)})
    return jctx, tctx


class TestDriftTerms:
    @pytest.mark.parametrize("name", TERMS)
    def test_term_matches_jax(self, name):
        jctx, tctx = drift_ctxs(11)
        got = getattr(tdrift, name)(tctx)
        want = getattr(jdrift, name)(jctx)
        assert got.dtype == torch.float32
        check(got, want, dict(rtol=1e-6, atol=1e-6), name)
        if name == "side_slip":
            assert 0 < (got.numpy() > 0).sum() < len(got)

    def test_reward_terms_match_jax(self):
        """Names, weights and order of the training variant's terms; with
        terminations stripped, term_pens is 0."""
        jt = jdrift.make_drift_task(jdrift.DriftTaskCfg(num_envs=8))
        tt = tdrift.make_drift_task(tdrift.DriftTaskCfg(num_envs=8))
        assert [(t.name, t.weight) for t in tt.reward_terms] == [
            (t.name, t.weight) for t in jt.reward_terms]
        stripped = tdrift.make_drift_task(tdrift.DriftTaskCfg(
            num_envs=8, terminations_enabled=False))
        _, tctx = drift_ctxs(12)
        assert (stripped.reward_terms[-1].fn(tctx) == 0).all()


def test_physics_bench_prints_four_rows(capsys):
    rows = physics_bench.main(["--device", "cpu", "--num-envs", "64",
                               "--rollout", "4", "--min-wall", "0.05"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == rows
    assert [r["metric"] for r in rows] == [
        "raw_physics", "physics_soa", "env_step_off", "env_step_kernel"]
    for r in rows:
        assert r["value"] > 0 and r["unit"] == "env-steps/s"
        assert r["timed_calls"] >= 4 and r["device"] == "cpu"
        assert r["kernel_launches"] == 0       # the CPU runs plain versions
