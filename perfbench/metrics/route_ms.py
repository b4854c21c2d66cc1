"""Mean ms per call of the program's ``route`` spans (Ph4–Ph6), every rung summed.

Layer: the tracer's two stages (``obs/trace.py``). A span runs from the
rung's launch to its overflow read.
"""


def read(ctx):
    durs = [s["dur"] for s in ctx.spans if s["name"] == "route"]
    return 1e3 * sum(durs) / ctx.traced_calls if durs and ctx.traced_calls else None
