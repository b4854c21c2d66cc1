"""Host ms per call inside the program's ``partition`` stage spans (Ph4).

Layer: Ph3–Ph5, sample, partition and exchange (``core/sort_det.py``
``route_det_spmd``, ``splitters.searchsorted_tagged``). Each rung's span
holds the time the host took to enqueue Ph4's launches (``host_ms``);
every rung of a call is summed.
"""


def read(ctx):
    ms = [s["args"]["host_ms"] for s in ctx.spans if s.get("cat") == "stage" and s["name"] == "partition"]
    return sum(ms) / ctx.traced_calls if ms and ctx.traced_calls else None
