"""setup_s: from the start of `run.py` to the start of the measured window
(host clock): imports, the kernels' load or build, env and learner, the
first iterations and the warm-up."""


def read(run):
    return run.setup_s
