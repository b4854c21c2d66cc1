"""Optimizer of the port: AdamW and int8 gradient compression."""
from .adamw import OptConfig, apply_updates, global_norm, init_state, schedule  # noqa: F401
from . import compress  # noqa: F401
