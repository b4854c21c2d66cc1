"""The LM stack of the port: the transformer family (dense, moe, vlm) with
the sort-dispatched MoE layer, the recurrent and audio families, and the
specs that place them on a ``DeviceMesh`` (``sharding``,
``place_model``)."""
from .lm import Model, make_mesh_info, place_model  # noqa: F401
from .moe import MoEMeshInfo  # noqa: F401
