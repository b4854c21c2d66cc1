"""Training of the port: the train step, checkpoint/restart and the
elastic control plane (``StragglerMonitor``, ``plan_remesh``,
``retry_capacity``, ``StepTimer``), as in the JAX package's
``repro.train``."""
from .train_step import init_all, make_train_step, train_step  # noqa: F401
from . import checkpoint, elastic  # noqa: F401
from .elastic import StepTimer, StragglerMonitor, plan_remesh, retry_capacity

__all__ = ["StepTimer", "StragglerMonitor", "checkpoint", "elastic", "init_all", "make_train_step",
           "plan_remesh", "retry_capacity", "train_step"]
