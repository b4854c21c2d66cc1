"""Ph6's share of its roofline, in %.

Layer: Ph6 merge (``core/merge.py``, ``kernels/merge_path``,
``kernels/searchsorted``). The received keys and payloads read once and
written once, over the card's bandwidth, ÷ the device time of the
operations launched inside the ``merge_tree`` range, over the profiled
calls.
"""
from perfbench import roofline


def read(ctx):
    device_s = ctx.trace.get("range_device_s", {}).get("merge_tree", 0.0)
    return roofline.share_pct(ctx.stage_bytes["merge_tree"] * ctx.profiled_calls, device_s)
