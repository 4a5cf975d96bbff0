"""ops_device_ms_per_step (ms, layer ops, am, ssm): the device time of
every kernel of the profiled window that is not one of the port's own
(PyTorch's: the window gathers, blurs, warp products, solves, the
pyramid), over its steps."""
from portbench.lib import trace as tr

PATTERNS = ("lk_fused_chain", "lk_fused_gn", "grid_flow_kernel")


def read(trace):
    ms, n = tr.kernel_ms(trace, PATTERNS, inside=False)
    if not n or not trace.profiled_steps:
        return None
    return ms / trace.profiled_steps
