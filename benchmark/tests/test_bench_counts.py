"""The yardstick's counts at small shapes: a kernel's least time, its
roofline share from a trace, and the policy's operations."""

import types

import pytest

from benchmark import roofline, spec, tracing


def test_least_time_takes_the_binding_bound():
    pk = {"hbm_bytes_per_s": 1e12, "flops_per_s": {"float32": 1e12}}
    assert roofline.least_seconds(
        {"bytes_per_env": 100, "ops_per_env": 10}, 1000, pk) == (1e-7, "bytes")
    assert roofline.least_seconds(
        {"bytes_per_env": 10, "ops_per_env": 100}, 1000, pk) == (
        1e-7, "operations")


def test_k1_counts_are_the_hand_counts():
    k1 = spec.read_json("counts", "k1.json")
    assert (k1["bytes_per_env"], k1["ops_per_env"]) == (604, 4 * 738 + 423)
    k3 = spec.read_json("counts", "k3.json")
    assert (k3["bytes_per_env"], k3["ops_per_env"]) == (960, 1068 * 10)


def fake_run(kernels, envs=1000, cell="drift_mushr_mlp.envs_65536"):
    c = spec.load_cell(cell)
    c = c._replace(traffic={"num_envs": envs})
    trace = tracing.TraceSummary(window_s=1.0, busy_s=0.25, kernels=kernels,
                                 idle_gaps=[], device_events=1)
    return types.SimpleNamespace(cell=c, trace=trace, iterations=2,
                                 window_s=4.0, traced_iterations=3)


def test_kernel_roofline_from_the_trace():
    least, _ = roofline.least_seconds(spec.read_json("counts", "k1.json"),
                                      1000, roofline.peaks())
    run = fake_run({"wl::fused_drift_kernel(args)": (4 * least * 10, 10),
                    "other": (1.0, 5)})
    assert roofline.kernel_roofline_pct(run, "k1") == pytest.approx(25.0)
    assert roofline.kernel_roofline_pct(fake_run({"other": (1.0, 5)}),
                                         "k1") is None
    assert roofline.kernel_roofline_pct(
        types.SimpleNamespace(trace=None), "k1") is None


def test_policy_flops_at_a_small_shape():
    cfg = {"obs_dim": 3, "action_dim": 2,
           "agent": {"actor_hidden": [4], "critic_hidden": [5],
                     "num_steps_per_env": 2, "num_mini_batches": 2,
                     "num_learning_epochs": 3}}
    # actor 3*4 + 4*2 = 20, critic 3*5 + 5*1 = 20 multiply-adds a sample
    assert roofline.policy_flops(cfg, 1) == 80
    # 7 envs: 14 rollout samples + 7 bootstrap, 14 // 2 * 2 = 14 samples x
    # 3 epochs x 3 passes in the update
    assert roofline.iteration_flops(cfg, 7) == 80 * (21 + 14 * 3 * 3)


def test_mfu_and_idle_readers():
    run = fake_run({}, envs=64)
    mfu = spec.load_module("metrics", "train_mfu_pct").read(run)
    flops = roofline.iteration_flops(run.cell.config, 64)
    # over the profiled iterations and window, not the measured window's
    assert mfu == pytest.approx(100 * flops * 3 / (1.0 * 67e12))
    untraced = run.__dict__ | {"trace": None}
    assert spec.load_module("metrics", "train_mfu_pct").read(
        types.SimpleNamespace(**untraced)) is None
    idle = spec.load_module("metrics", "device_idle_pct").read(run)
    assert idle == pytest.approx(75.0)
