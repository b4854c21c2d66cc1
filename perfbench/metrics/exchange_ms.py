"""Device stream ms per call inside the program's ``exchange`` stage spans (Ph5).

Layer: Ph3–Ph5, sample, partition and exchange (``core/routing.py``
``route_and_merge`` around ``recv_rows``). The ``stream_ms`` of each
rung's span, the time between CUDA events at the stage's edges; every
rung of a call is summed. Spans without a stream time (off CUDA) read
nothing.
"""


def read(ctx):
    ms = [s["args"].get("stream_ms") for s in ctx.spans if s.get("cat") == "stage" and s["name"] == "exchange"]
    ms = [v for v in ms if v is not None]
    return sum(ms) / ctx.traced_calls if ms and ctx.traced_calls else None
