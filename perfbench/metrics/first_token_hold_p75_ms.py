"""75th percentile of how long a request's first token waits in the
server, in ms: the program's ``request.hold`` intervals (from the first
token computed to its batch handed to the channel), over the requests due
in the window of an open loop, as ``ttft_p75_ms`` takes them
(``perfbench/spans.py``).  Read over a traced run, in which about one step
in ten is profiled: a hold that ended while the profiler recorded is left
out, the others may have waited behind profiled steps."""
from perfbench.spans import request_p75_ms


def read(run, ctx):
    return request_p75_ms(run, "request.hold")
