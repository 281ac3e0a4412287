"""rollout_ms: mean device time of one `PPO.rollout` call (128 env steps and the policy's forward) over the measured window, from CUDA events the benchmark records around each call."""


def read(run):
    ms = run.spans_ms.get("rollout")
    return sum(ms) / len(ms) if ms else None
