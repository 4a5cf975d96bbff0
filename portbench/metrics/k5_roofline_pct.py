"""k5_roofline_pct (%, layer ops.kernels + csrc): K5's share of its
roofline. The least times of its launches (lib/bounds.py: bound by the
operations at Median Flow's shapes) summed per step in a probe, over
their device time per step in the profiled window."""
from portbench.lib import bounds, trace as tr

PATTERNS = ("grid_flow_kernel",)
# the program's call of the grid flow, from the grid search methods
WRAP = ("mtf_tpu_torch.sm.grid", "grid_flow")


def bound(result, *args, **kwargs):
    return bounds.k5_bound_ms(result, *args, **kwargs)


def read(trace):
    return tr.roofline_pct(trace, "k5_roofline_pct", PATTERNS)
