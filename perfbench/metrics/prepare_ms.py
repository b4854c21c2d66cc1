"""Mean ms per call of the program's ``prepare`` span (Ph2 and Ph3).

Layer: the tracer's two stages (``obs/trace.py``). The span is
synchronized with the device at both edges, so it holds the device's time.
"""


def read(ctx):
    durs = [s["dur"] for s in ctx.spans if s["name"] == "prepare"]
    return 1e3 * sum(durs) / ctx.traced_calls if durs and ctx.traced_calls else None
