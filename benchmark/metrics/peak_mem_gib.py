"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the whole run,
set-up included, read once the window has closed, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30
