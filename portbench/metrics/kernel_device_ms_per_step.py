"""kernel_device_ms_per_step (ms, layer ops.kernels + csrc): the device
time of the port's own CUDA kernels in the profiled window, over its
steps. The names are those of the `__global__` functions of
`mtf_tpu_torch/csrc/*.cu`."""
from portbench.lib import trace as tr

PATTERNS = ("lk_fused_chain", "lk_fused_gn", "grid_flow_kernel")


def read(trace):
    ms, n = tr.kernel_ms(trace, PATTERNS)
    if not n or not trace.profiled_steps:
        return None
    return ms / trace.profiled_steps
