"""device_idle_pct (%, layer device): 100 x (1 - the union of the device
ops' intervals over the profiled window), from the profiler's timeline;
the window runs from the first profiled step's start to the later of
the last step's end and the last device op's end."""
from portbench.lib import trace as tr


def read(trace):
    lo, hi = trace.window_us
    if not trace.device_ops or hi <= lo:
        return None
    return (1.0 - tr.busy_us(trace) / (hi - lo)) * 100.0
