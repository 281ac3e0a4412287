"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card: 100 x (1 - the union of their intervals /
the window)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
