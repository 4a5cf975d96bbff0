"""host_ms_per_step (ms, layer parallel.fleet + sm): the benchmark's
host-clock span around the fleet call (`update_multi`, up to its
return), summed over the timed window's steps, over the steps. The call
returns once its launches are queued, so this is the host's dispatch."""


def read(trace):
    spans = trace.spans.get("fleet_call")
    if not spans or not trace.timed_steps:
        return None
    return sum(spans) / trace.timed_steps * 1e3
