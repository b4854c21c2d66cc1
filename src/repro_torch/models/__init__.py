"""The LM stack of the port: the transformer family (dense, moe, vlm) with
the sort-dispatched MoE layer, on one device."""
from .lm import Model  # noqa: F401
from .moe import MoEMeshInfo  # noqa: F401
