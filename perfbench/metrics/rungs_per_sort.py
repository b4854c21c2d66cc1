"""Rungs of the capacity ladder walked per sort: ``TierStats`` attempts ÷ calls.

Layer: the driver and capacity ladder (``core/api.py``). 1 where the
first rung holds; each overflow adds a rung that re-runs Ph4–Ph6.
"""


def read(ctx):
    return ctx.rung_attempts / ctx.calls if ctx.calls else None
