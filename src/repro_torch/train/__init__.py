"""Training control plane of the port.

Only ``elastic`` (``StragglerMonitor``, ``plan_remesh``, ``retry_capacity``,
``StepTimer``) is ported so far: the sort service's dispatcher feeds its
flight walls to the straggler monitor. The train step and checkpointing
of the JAX package's ``repro.train`` wait for the LM stack.
"""
from . import elastic  # noqa: F401
from .elastic import StepTimer, StragglerMonitor, plan_remesh, retry_capacity

__all__ = ["StepTimer", "StragglerMonitor", "elastic", "plan_remesh", "retry_capacity"]
