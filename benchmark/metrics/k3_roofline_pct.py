"""k3_roofline_pct: K3's (`csrc/physics_step_hf.cu`) share of its roofline:
the least time a launch could take (960 B an env at the HBM rate, or
10,680 operations an env at the float32 rate, whichever is longer;
`counts/k3.json`) over its mean device time per launch in the trace."""

from benchmark.roofline import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "k3")
