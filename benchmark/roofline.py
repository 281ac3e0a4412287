"""The yardstick of the per-layer shares: the card's published peaks
(`peaks.json`), each kernel's work per env (`counts/<kernel>.json`) and the
policy's operations counted from its shapes."""

from __future__ import annotations

import sys
from typing import Optional

from . import spec


def peaks() -> dict:
    return spec.read_json("peaks.json")


def least_seconds(counts: dict, envs: int, pk: dict) -> tuple:
    """(the least time one launch over `envs` envs could take, the bound
    that sets it): the larger of its bytes over the HBM rate and its
    operations over the float32 rate."""
    by_bytes = counts["bytes_per_env"] * envs / pk["hbm_bytes_per_s"]
    by_ops = counts["ops_per_env"] * envs / pk["flops_per_s"]["float32"]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_roofline_pct(run, kernel: str) -> Optional[float]:
    """100 x least time / measured time of one launch of `kernel`, the
    measured time its summed device time in the trace over its launches;
    None when the trace holds no launch of it."""
    if run.trace is None:
        return None
    counts = spec.read_json("counts", kernel + ".json")
    hits = [v for k, v in run.trace.kernels.items() if counts["kernel"] in k]
    launches = sum(n for _, n in hits)
    if not launches:
        return None
    measured = sum(s for s, _ in hits) / launches
    least, bound = least_seconds(counts, run.cell.num_envs, peaks())
    print(f"{kernel}: {launches} launches, {1e3 * measured:.6f} ms each, "
          f"least {1e3 * least:.6f} ms, bound by {bound}", file=sys.stderr)
    return 100.0 * least / measured


def policy_flops(config: dict, samples: int, passes: int = 1) -> float:
    """Operations of `passes` x `samples` forward passes of the actor and
    the critic: 2 per multiply-add of their linear layers (a backward pass
    counts as two forwards)."""
    a = config["agent"]
    macs = 0
    for hidden, out in ((a["actor_hidden"], config["action_dim"]),
                        (a["critic_hidden"], 1)):
        widths = [config["obs_dim"], *hidden, out]
        macs += sum(i * o for i, o in zip(widths, widths[1:]))
    return 2.0 * macs * samples * passes


def iteration_flops(config: dict, num_envs: int) -> float:
    """The policy's operations in one PPO iteration: a forward for each
    rollout sample and for the bootstrap value, and a forward and backward
    (3 forwards) for each sample of each epoch's minibatches."""
    a = config["agent"]
    samples = a["num_steps_per_env"] * num_envs
    used = samples // a["num_mini_batches"] * a["num_mini_batches"]
    return (policy_flops(config, samples + num_envs)
            + policy_flops(config, used * a["num_learning_epochs"], 3))


def matmul_peak(config: dict) -> float:
    """The peak of the precision the policy's products run in."""
    import torch

    pk = peaks()["flops_per_s"]
    if config["agent"]["compute_dtype"] == "bfloat16":
        return pk["bfloat16"]
    return pk["tf32"] if torch.backends.cuda.matmul.allow_tf32 else pk["float32"]
