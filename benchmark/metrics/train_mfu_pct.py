"""train_mfu_pct: the policy's operations in the iterations run under the
profiler (`roofline.iteration_flops` a PPO iteration, counted from its
shapes) over the profiled window's length in the device trace x the peak
of the precision its products run in (67 TFLOP/s float32 with TF32 off).
The window holds the profiler's own host cost, so the share reads below
that of an untraced iteration."""

from benchmark.roofline import iteration_flops, matmul_peak


def read(run):
    if run.trace is None or not run.traced_iterations:
        return None
    flops = iteration_flops(run.cell.config, run.cell.num_envs)
    return (100.0 * flops * run.traced_iterations
            / (run.trace.window_s * matmul_peak(run.cell.config)))
