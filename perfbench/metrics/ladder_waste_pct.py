"""Share of the sort's device stream time spent in rungs that overflowed.

Layer: the driver and its capacity ladder (``core/api.py``). 100 × the
``stream_ms`` of the ``route`` spans whose rung overflowed (``ok`` false)
÷ the ``stream_ms`` of every ``prepare`` and ``route`` span, over the
traced calls. A program whose spans carry no ``stream_ms`` reads nothing.
"""


def read(ctx):
    spans = [s for s in ctx.spans if s["name"] in ("prepare", "route")
             and s["args"].get("stream_ms") is not None]
    total = sum(s["args"]["stream_ms"] for s in spans)
    if not total:
        return None
    lost = sum(s["args"]["stream_ms"] for s in spans if s["name"] == "route" and not s["args"].get("ok"))
    return 100.0 * lost / total
