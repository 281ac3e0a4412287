"""env_step_ms: mean device time of one `WheeledEnv.step` call over the measured window, from CUDA events the benchmark records around each call."""


def read(run):
    ms = run.spans_ms.get("env_step")
    return sum(ms) / len(ms) if ms else None
