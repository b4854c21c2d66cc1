"""Ph2's share of its roofline, in %.

Layer: Ph2 local sort (``core/local_sort.py``, ``kernels/bitonic``). The
stage's least time (each key and payload byte read once and written once,
over the card's bandwidth) ÷ the device time of the operations launched
inside the ``local_sort`` range, over the profiled calls.
"""
from perfbench import roofline


def read(ctx):
    device_s = ctx.trace.get("range_device_s", {}).get("local_sort", 0.0)
    return roofline.share_pct(ctx.stage_bytes["local_sort"] * ctx.profiled_calls, device_s)
