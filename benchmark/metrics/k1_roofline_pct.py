"""k1_roofline_pct: K1's (`csrc/fused_drift.cu`) share of its roofline:
the least time a launch could take (604 B an env at the HBM rate, or 3,375
operations an env at the float32 rate, whichever is longer;
`counts/k1.json`) over its mean device time per launch in the trace."""

from benchmark.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "k1")
