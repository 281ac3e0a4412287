"""update_ms: mean device time of one `PPO.update_epochs` call (5 epochs x 4 minibatches) over the measured window, from CUDA events the benchmark records around each call."""


def read(run):
    ms = run.spans_ms.get("update")
    return sum(ms) / len(ms) if ms else None
