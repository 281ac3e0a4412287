"""The drift step that draws its own random rows
(`wheeledlab_torch/tasks/drift/fused.py::fused_drift_step_krng`, the port of
`fused_drift_pallas_krng`) on the CPU.

The reference kernel draws from the TPU's hardware generator and has no
interpret path, so parity is held where the randomness is an input: the
port's plain route (Philox rows, then `drift_step_rows`) against the JAX
`drift_step_rows` and the Pallas kernel `fused_drift_pallas` in interpret
mode, both fed the port's Philox rows as numpy. The env-level tests hold the
opt-in route (`WHEELEDLAB_KERNEL_RNG=1`) and, statistically, both routes
against `tests/golden_drift.json`.

The kernel itself only runs on a GPU; `chip_smoke.py` holds it against the
plain route there."""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_fused_drift import (
    assert_outputs_match, consts, jax_rows, np_inputs, torch_inputs,
)
from test_torch_train import read_metrics, tiny_cfg
from wheeledlab_tpu.tasks.drift import fused as jfused
from wheeledlab_torch.ops.kernel_rng import philox_blocks
from wheeledlab_torch.rl.runner import train
from wheeledlab_torch.tasks.drift import fused as tfused
from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_env

torch.set_num_threads(1)

CASES = {
    "mushr_noise": dict(robot="mushr"),
    "f1tenth_noise": dict(robot="f1tenth"),
    "mushr_no_noise": dict(robot="mushr", enable_corruption=False),
    "f1tenth_no_noise": dict(robot="f1tenth", enable_corruption=False),
}


def krng_inputs(case, b, seed):
    """(JAX consts, port consts, numpy inputs with the port's Philox rows of
    `seed` in place of numpy's, the seed tensor)."""
    jc, tc, jtask_cfg = consts(num_envs=b, **CASES[case])
    x = np_inputs(jc, jtask_cfg, b, seed=seed)
    seed_t = torch.tensor([seed], dtype=torch.int32)
    uniforms, normals = philox_blocks(seed_t, b, tc.enable_corruption)
    x["uniforms"], x["normals"] = uniforms.numpy(), normals.numpy()
    return jc, tc, x, seed_t


def krng_step(tc, x, seed_t):
    t = torch_inputs({k: v for k, v in x.items()
                      if k not in ("uniforms", "normals")})
    return tfused.fused_drift_step_krng(cfg=tc, seed=seed_t, **t)


class TestKrngStep:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax_rows_fed_the_philox_rows(self, case):
        """Tolerance: that of tests/test_torch_fused_drift.py (one control
        step, port against reference)."""
        jc, tc, x, seed_t = krng_inputs(case, 256, seed=len(case))
        before = tfused.LAUNCHES_KRNG
        got = krng_step(tc, x, seed_t)
        assert tfused.LAUNCHES_KRNG == before     # CPU calls launch nothing
        want = jax_rows(jc, x)
        assert_outputs_match(got, want)
        done, time_out = want[2][tfused.O_DONE], want[2][tfused.O_TIMEOUT]
        assert 0 < time_out.sum() < done.sum()

    def test_matches_pallas_interpret_fed_the_philox_rows(self):
        jc, tc, x, seed_t = krng_inputs("mushr_noise", 32, seed=7)
        weights_pad = np.concatenate([x["weights"], [0.0]]).astype(
            np.float32)[None]
        want = jfused.fused_drift_pallas(
            weights_pad, x["poses"], x["state"], x["params"],
            x["action_rows"], x["uniforms"], x["normals"], x["step_count"],
            x["timers"], x["ep_return"], x["ep_len"], cfg=jc,
            n_push=max(len(jc.pushes), 1), interpret=True)
        assert_outputs_match(krng_step(tc, x, seed_t),
                             [np.asarray(w) for w in want])

    def test_is_the_streamed_step_on_the_philox_rows(self):
        """Bit for bit: the seed only chooses the rows."""
        _, tc, x, seed_t = krng_inputs("f1tenth_noise", 64, seed=3)
        via_rows = tfused.fused_drift_step(cfg=tc, **torch_inputs(x))
        for g, w in zip(krng_step(tc, x, seed_t), via_rows):
            assert torch.equal(g, w)
        other = krng_step(tc, x, torch.tensor([4], dtype=torch.int32))
        assert not torch.equal(other[1], via_rows[1])

    def test_rejects_bad_inputs(self):
        _, tc, x, seed_t = krng_inputs("mushr_noise", 8, seed=1)
        with pytest.raises(TypeError):
            krng_step(tc, x, seed_t.long())
        with pytest.raises(TypeError):
            krng_step(tc, {**x, "ep_len": x["ep_len"].astype(np.float32)},
                      seed_t)
        with pytest.raises(ValueError):
            krng_step(tc, {**x, "state": x["state"][:, :4]}, seed_t)
        with pytest.raises(ValueError, match="seed is on"):
            krng_step(tc, x, seed_t.to("meta"))


def spy(monkeypatch):
    """Count the calls of the two wrappers."""
    calls = {"streamed": 0, "krng": 0}
    streamed, krng = tfused.fused_drift_step, tfused.fused_drift_step_krng

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tfused, "fused_drift_step", count("streamed",
                                                          streamed))
    monkeypatch.setattr(tfused, "fused_drift_step_krng", count("krng", krng))
    return calls


def roll(env, steps, seed=0):
    g = torch.Generator().manual_seed(seed)
    state, _ = env.reset()
    outs = []
    for _ in range(steps):
        state, out = env.step(state, torch.rand((env.num_envs, 2),
                                                generator=g) * 2 - 1)
        outs.append(out)
    return state, outs


class TestEnvRoute:
    def test_variable_selects_the_philox_route(self, monkeypatch):
        """Read once, when the env is built; honoured on the CPU, where the
        plain version runs."""
        calls = spy(monkeypatch)
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
        env = make_drift_env(DriftTaskCfg(num_envs=16), device="cpu", seed=3)
        monkeypatch.delenv("WHEELEDLAB_KERNEL_RNG")
        state, outs = roll(env, 5)
        assert calls == {"streamed": 0, "krng": 5}
        assert all(torch.isfinite(o.obs).all() for o in outs)

    @pytest.mark.parametrize("value", [None, "0", "true"])
    def test_without_the_variable_nothing_changes(self, monkeypatch, value):
        calls = spy(monkeypatch)
        if value is None:
            monkeypatch.delenv("WHEELEDLAB_KERNEL_RNG", raising=False)
        else:
            monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", value)
        env = make_drift_env(DriftTaskCfg(num_envs=16), device="cpu", seed=3)
        roll(env, 3)
        assert calls == {"streamed": 3, "krng": 0}

    def test_deterministic_per_seed(self, monkeypatch):
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
        runs = [roll(make_drift_env(DriftTaskCfg(num_envs=16), device="cpu",
                                    seed=s), 6)[1] for s in (3, 3, 4)]
        for a, b in zip(runs[0], runs[1]):
            assert torch.equal(a.obs, b.obs) and torch.equal(a.reward,
                                                             b.reward)
        assert not torch.equal(runs[0][-1].obs, runs[2][-1].obs)

    def test_resumes_exactly_from_a_checkpoint(self, monkeypatch, tmp_path):
        """One generator draw per step makes the seed: a checkpoint's
        generator state resumes the Philox route exactly."""
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
        calls = spy(monkeypatch)
        train(tiny_cfg(tmp_path, "k1", 2), verbose=False)
        train(tiny_cfg(tmp_path, "k2", 3, **{"train.load_run": "k1"}),
              verbose=False)
        train(tiny_cfg(tmp_path, "k3", 3), verbose=False)
        assert calls["streamed"] == 0 and calls["krng"] == 6 * 8
        resumed = read_metrics(tmp_path, "k2")
        straight = read_metrics(tmp_path, "k3")[-1]
        assert [r["iteration"] for r in resumed] == [3]
        for k in ("loss/total", "loss/kl", "lr", "rollout/reward_mean",
                  "episode/num_dones", "metrics/speed"):
            assert resumed[0][k] == straight[k], k


# The JAX env's own spread of the golden statistics: the largest
# |stat - golden| over 8 (reset, action) seed pairs of
# tests/test_golden.py::compute_drift_stats, (1234, 5678) and (1, 2) ...
# (13, 14), measured on the CPU (`python tests/test_torch_fused_drift_krng.py
# --measure-spread` prints it).
JAX_SPREAD = {
    "reward_mean": 0.1213, "reward_std": 1.831, "speed_mean": 0.03333,
    "speed_max": 0.2242, "xy_abs_mean": 0.1142, "z_mean": 3.673e-06,
    "done_frac": 0.00125,
}
# one more rollout may fall a little outside 8 samples' range
SPREAD_MARGIN = 1.25
SEED_PAIRS = [(1234, 5678)] + [(2 * i + 1, 2 * i + 2) for i in range(7)]


@pytest.mark.parametrize("route", ["streamed", "philox"])
def test_golden_statistics_within_jax_spread(route, monkeypatch):
    """A port rollout of the golden drift config (32 envs, 100 steps of
    uniform random actions, tests/test_golden.py:51-56) under the streamed
    route and under the Philox route: every statistic within SPREAD_MARGIN x
    the JAX env's own spread of the golden value. The spawn pose table is
    a constant of the task seed that the two packages draw from different
    generators, so the port is handed the reference's table (the spread
    over env seeds does not cover another table)."""
    import jax

    from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JCfg
    from wheeledlab_tpu.tasks.drift.task import reference_track_poses

    jcfg = JCfg(num_envs=32)
    poses = np.asarray(reference_track_poses(
        jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), 17), jcfg))
    if route == "philox":
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
    else:
        monkeypatch.delenv("WHEELEDLAB_KERNEL_RNG", raising=False)
    calls = spy(monkeypatch)
    env = make_drift_env(DriftTaskCfg(num_envs=32), device="cpu", seed=0,
                         ref_poses=torch.tensor(poses))
    g = torch.Generator().manual_seed(1000)
    state, _ = env.reset()
    rew, pos, vel, done = [], [], [], []
    for _ in range(100):
        state, out = env.step(state, torch.rand((32, 2), generator=g) * 2 - 1)
        v = state.vehicle
        for acc, x in ((rew, out.reward), (pos, v.pos), (vel, v.lin_vel),
                       (done, out.done)):
            acc.append(x)
    assert calls == ({"streamed": 0, "krng": 100} if route == "philox"
                     else {"streamed": 100, "krng": 0})
    rew, pos, vel, done = map(torch.stack, (rew, pos, vel, done))
    speed = torch.linalg.vector_norm(vel[..., :2], dim=-1)
    got = {
        "reward_mean": rew.mean(), "reward_std": rew.std(correction=0),
        "speed_mean": speed.mean(), "speed_max": speed.max(),
        "xy_abs_mean": pos[..., :2].abs().mean(), "z_mean": pos[..., 2].mean(),
        "done_frac": done.float().mean(),
    }
    golden = json.load(open(os.path.join(os.path.dirname(__file__),
                                         "golden_drift.json")))
    assert sorted(golden) == sorted(got) == sorted(JAX_SPREAD)
    for k, ref in golden.items():
        assert abs(float(got[k]) - ref) <= SPREAD_MARGIN * JAX_SPREAD[k], \
            f"{k}: port {float(got[k])}, golden {ref}"


def measure_jax_spread():
    """The JAX drift env's spread of the golden statistics over SEED_PAIRS."""
    from test_golden import base_stats, rollout
    from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JCfg
    from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env

    golden = json.load(open(os.path.join(os.path.dirname(__file__),
                                         "golden_drift.json")))
    env = j_make_env(JCfg(num_envs=32))
    spread = dict.fromkeys(golden, 0.0)
    for reset_seed, action_seed in SEED_PAIRS:
        rew, pos, vel, done, _ = rollout(env, 32, 100, reset_seed,
                                         action_seed)
        stats = base_stats(rew, pos, vel, done)
        for k in golden:
            spread[k] = max(spread[k], abs(stats[k] - golden[k]))
    return spread


if __name__ == "__main__":
    import sys

    if "--measure-spread" in sys.argv:
        print(json.dumps(measure_jax_spread(), indent=1))
    else:
        sys.exit(pytest.main([__file__, "-x", "-q"]))
