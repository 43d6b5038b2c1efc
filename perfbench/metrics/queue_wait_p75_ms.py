"""75th percentile of a request's wait for a slot, in ms: the program's
``request.queue`` intervals (from its arrival in the server's admission
queue to the start of its prefill), over the requests due in the window
of an open loop, as ``ttft_p75_ms`` takes them (``perfbench/spans.py``).
Read over a traced run, in which about one step in ten is profiled: a wait
that ended while the profiler recorded is left out, the others may have
waited behind profiled steps.  A request never admitted has no interval."""
from perfbench.spans import request_p75_ms


def read(run, ctx):
    return request_p75_ms(run, "request.queue")
