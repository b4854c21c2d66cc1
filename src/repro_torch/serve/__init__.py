from .engine import ServeConfig, ServeEngine  # noqa: F401
from .sampling import sample, top_k_logits  # noqa: F401
