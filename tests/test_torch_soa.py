"""Parity of the port's packed-row physics (`wheeledlab_torch/sim/soa.py`)
with the JAX reference (`wheeledlab_tpu/sim/soa.py`) on the CPU.

Inputs are made with numpy from a seed and handed to both packages: random
states and DR params in the pattern of tests/test_pallas.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.assets import F1TENTH_CFG as J_F1TENTH
from wheeledlab_tpu.assets import MUSHR_SUS_2WD_CFG as J_MUSHR
from wheeledlab_tpu.sim.actions import ActionMapCfg as JActionMapCfg
from wheeledlab_tpu.sim.actions import action_to_targets as j_targets
from wheeledlab_tpu.sim import soa as jsoa
from wheeledlab_tpu.sim.types import VehicleState as JState
from wheeledlab_tpu.sim.types import batch_params as j_batch
from wheeledlab_tpu.sim.types import with_mass as j_with_mass
from wheeledlab_torch.assets.robots import F1TENTH_CFG, MUSHR_SUS_2WD_CFG
from wheeledlab_torch.sim.actions import ActionMapCfg, action_to_targets
from wheeledlab_torch.sim import soa as tsoa
from wheeledlab_torch.sim.types import VehicleState, batch_params, with_mass

torch.set_num_threads(1)

B = 32
DT = 0.005
STATE_FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "wheel_omega",
                "steer_pos", "steer_vel")


def np_states(seed, b=B):
    """The tests/test_pallas.py::random_states distribution, from numpy."""
    rng = np.random.default_rng(seed)
    u = lambda s, lo, hi: rng.uniform(lo, hi, s).astype(np.float32)
    quat = rng.standard_normal((b, 4)).astype(np.float32)
    quat[:, 0] += 4.0
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return dict(
        pos=u((b, 3), -1, 1) * np.float32([1, 1, 0.02])
        + np.float32([0, 0, 0.06]),
        quat=quat,
        lin_vel=u((b, 3), -3, 3) * np.float32([1, 1, 0.1]),
        ang_vel=u((b, 3), -2, 2) * np.float32([0.2, 0.2, 1]),
        wheel_omega=u((b, 4), -10, 80),
        steer_pos=u((b, 2), -0.5, 0.5),
        steer_vel=u((b, 2), -2, 2),
    )


def dr_params(robot, seed, b=B):
    """DR'd params built by each package from its own asset config, with
    the same numpy friction/mass draws -> (JAX params, port params)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.3, 0.5, (b, 4)).astype(np.float32)
    mass_add = rng.uniform(0.3, 0.5, (b,)).astype(np.float32)
    jbase, tbase = {"mushr": (J_MUSHR, MUSHR_SUS_2WD_CFG),
                    "f1tenth": (J_F1TENTH, F1TENTH_CFG)}[robot]
    jp = j_batch(jbase, b).replace(tire_mu=jnp.asarray(mu))
    jp = j_with_mass(jp, jp.mass + jnp.asarray(mass_add))
    tp = batch_params(tbase, b).replace(tire_mu=torch.from_numpy(mu))
    tp = with_mass(tp, tp.mass + torch.from_numpy(mass_add))
    return jp, tp


class TestApprox:
    """The shared atan/atan2/asin approximations, including the edge cases
    the sign-preserving clamp exists for. Same float32 operations in the
    same order on both sides, so they agree to float rounding."""

    XS = np.float32([0.0, -0.0, 1e-35, -1e-35, -1e-31, 1e-31, 0.5, -0.5,
                     1.0, -1.0, 1.5, -1.5, 100.0, -100.0, 3e4, -3e4])

    def test_atan_approx(self):
        got = tsoa.atan_approx(torch.from_numpy(self.XS)).numpy()
        want = np.asarray(jsoa.atan_approx(jnp.asarray(self.XS)))
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)

    def test_atan2_approx(self):
        y, x = np.meshgrid(self.XS, self.XS)
        got = tsoa.atan2_approx(torch.from_numpy(y),
                                torch.from_numpy(x)).numpy()
        want = np.asarray(jsoa.atan2_approx(jnp.asarray(y), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        assert np.all(np.abs(got) <= np.float32(np.pi) + 1e-6)

    def test_asin_approx(self):
        xs = np.concatenate([self.XS, np.linspace(-1.2, 1.2, 49,
                                                  dtype=np.float32)])
        got = tsoa.asin_approx(torch.from_numpy(xs)).numpy()
        want = np.asarray(jsoa.asin_approx(jnp.asarray(xs)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


class TestActionMaps:
    @pytest.mark.parametrize("drivetrain,bounding", [
        ("rwd", "clip"), ("4wd", "tanh"), ("ackermann", None)])
    def test_action_to_targets_matches_jax(self, drivetrain, bounding):
        """Policy actions -> steer/wheel targets; same float32 ops, with
        libm tan/atan/sqrt of the two packages differing in the last
        ulp."""
        raw = np.random.default_rng(6).normal(0, 1.5, (64, 2)).astype(
            np.float32)
        raw[0] = 0.0    # zero steer: the straight-line branch
        kw = dict(drivetrain=drivetrain, bounding_strategy=bounding,
                  base_length=0.365, base_width=0.284)
        got = action_to_targets(torch.from_numpy(raw), ActionMapCfg(**kw))
        want = j_targets(jnp.asarray(raw), JActionMapCfg(**kw))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


class TestPacking:
    def test_pack_unpack_roundtrip(self):
        s = np_states(0)
        tv = VehicleState(**{k: torch.from_numpy(v) for k, v in s.items()})
        packed = tsoa.pack_state(tv)
        assert packed.shape == (tsoa.NUM_STATE, B) and packed.is_contiguous()
        want = np.asarray(jsoa.pack_state(
            JState(**{k: jnp.asarray(v) for k, v in s.items()})))
        np.testing.assert_array_equal(packed.numpy(), want)
        rt = tsoa.unpack_state(packed)
        for k in STATE_FIELDS:
            np.testing.assert_array_equal(getattr(rt, k).numpy(), s[k])

    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    def test_pack_params_matches_jax(self, robot):
        """The port's own asset configs, DR and packing give the reference
        (46, B) block (suspension retune in float32 on both sides)."""
        jp, tp = dr_params(robot, 1)
        got = tsoa.pack_params(tp, 1.0).numpy()
        want = np.asarray(jsoa.pack_params(jp, 1.0))
        assert got.shape == (tsoa.NUM_PARAM, B)
        np.testing.assert_array_equal(got, want)


class TestSubstep:
    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    @pytest.mark.parametrize("substeps", [1, 4])
    def test_substep_matches_jax(self, robot, substeps):
        """`substep_soa` chained `substeps` times. Tolerance: the two
        packages' float32 sin/cos/tanh differ in the last ulp, and the
        stiff tire/suspension contact amplifies that over 4 substeps;
        measured max difference 6e-6 absolute, 1e-6 relative."""
        s = np_states(2)
        _, tp = dr_params(robot, 3)
        pparams = tsoa.pack_params(tp, 1.0)
        rng = np.random.default_rng(4)
        steer_t = rng.uniform(-0.5, 0.5, (2, B)).astype(np.float32)
        wheel_t = rng.uniform(0.0, 60.0, (4, B)).astype(np.float32)

        packed = tsoa.pack_state(
            VehicleState(**{k: torch.from_numpy(v) for k, v in s.items()}))
        got = packed
        for _ in range(substeps):
            got = tsoa.substep_soa(got, pparams, torch.from_numpy(steer_t),
                                   torch.from_numpy(wheel_t), DT)

        def jax_steps(m, p, st, wt):
            for _ in range(substeps):
                m = jsoa.substep_soa(m, p, st, wt, DT)
            return m

        want = jax.jit(jax_steps)(jnp.asarray(packed.numpy()),
                                  jnp.asarray(pparams.numpy()),
                                  jnp.asarray(steer_t), jnp.asarray(wheel_t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=5e-5)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
