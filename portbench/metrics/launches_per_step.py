"""launches_per_step (launches, layer parallel.fleet + sm): the CUDA
kernels of the profiled window over its steps (copies and fills are not
kernels). The count repeats exactly from step to step."""


def read(trace):
    n = len(trace.kernels)
    if not n or not trace.profiled_steps:
        return None
    return n / trace.profiled_steps
