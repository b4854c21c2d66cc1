"""Roofline terms of the port's steps (``analysis``): FLOPs and bytes
counted from the dispatched matrix products, against the H100 SXM's
published peaks."""
from .analysis import HBM_BW, PEAK_FLOPS, analyze, count_step, model_flops  # noqa: F401
