"""The paper's balance claim: largest received run ÷ mean, per sort.

Layer: Ph3–Ph5, sample, partition and exchange (``core/sort_det.py``,
``splitters.py``, ``routing.py``). The mean over the traced calls of the
``imbalance`` argument of the ``route`` span whose rung succeeded.
"""


def read(ctx):
    vals = [s["args"]["imbalance"] for s in ctx.spans if s["name"] == "route" and s["args"].get("ok")]
    return sum(vals) / len(vals) if vals else None
