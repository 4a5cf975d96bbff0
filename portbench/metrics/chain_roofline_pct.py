"""chain_roofline_pct (%, layer ops.kernels + csrc): the chain kernel's
share of its roofline. Its launches' least times (lib/bounds.py, at each
launch's own operands: N = 169, 625, 2500 by the coarse-to-fine
schedule) summed per step in a probe, over their device time per step
in the profiled window."""
from portbench.lib import bounds, trace as tr

PATTERNS = ("lk_fused_chain",)
# the program's call of the chain kernel, from the LK search methods
WRAP = ("mtf_tpu_torch.sm.lk", "lk_fused_chain")


def bound(result, *args, **kwargs):
    return bounds.chain_bound_ms(*args, **kwargs)


def read(trace):
    return tr.roofline_pct(trace, "chain_roofline_pct", PATTERNS)
