"""The card's idle share of the profiled part of the window, in %.

Layer: the device. 100 × (1 − the union of the device operations'
intervals ÷ the profiled part's wall), both from the same trace;
nothing where no operation ran on a device.
"""


def read(ctx):
    w, busy = ctx.trace.get("window_s", 0.0), ctx.trace.get("busy_s", 0.0)
    return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None
