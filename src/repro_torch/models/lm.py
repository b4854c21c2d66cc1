"""Unified model API of the port.

    model = Model(cfg)                    # random weights on the card
    model = Model(cfg, device="cpu", params=params_from_reference(tree, device="cpu"))
    loss, aux = model.train_loss(batch)
    cache, logits = model.prefill(batch, cache_len=...)
    logits, cache = model.decode_step(cache, token)

``Model`` is an ``nn.Module`` that holds its parameters under the JAX
package's leaf names, each stacked leaf of the reference split into one
parameter per layer (or per block and slot), the indices in its path:

* transformer (``dense``, ``moe``, ``vlm``): ``layers.<i>.<leaf>``;
* ``hybrid`` (jamba): ``blocks.<b>.attn.<leaf>``,
  ``blocks.<b>.{mamba,dense,moe}.<slot>.<leaf>`` and
  ``blocks.<b>.{attn_norm,mlp_norm}.<i>``;
* ``ssm`` (xlstm): ``mlstm.<i>.<leaf>`` and ``slstm.<i>.<leaf>``;
* ``audio`` (whisper): ``enc.<i>.<leaf>`` and ``dec.<i>.<leaf>``, beside
  ``enc_final_norm``;

beside the top-level ``embed``, ``final_norm`` and ``lm_head``. A run of
integer path segments is an ``nn.ModuleList`` (or ``nn.ParameterList``),
named segments an ``nn.ModuleDict`` (or ``nn.ParameterDict``), so the
state-dict names are these names.

On a ``DeviceMesh``, :func:`place_model` places the parameters by their
sanitized specs (``models.sharding``) and :func:`make_mesh_info` gives the
steps their view of the mesh.

For the dry-run, ``Model.param_shapes(cfg)`` gives the parameters and
``model.input_specs(shape)`` every input of a shape's step as tensors on
the ``meta`` device: shapes and dtypes, no memory. ``Model(cfg,
device="meta")`` is a model of such tensors, whose steps run without
computing anything.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig, ShapeConfig
from ..core.types import resolve_device, to_device
from . import encdec, hybrid, transformer, xlstm
from . import sharding as shd
from .layers import MetaGenerator, dtype_of
from .moe import MoEMeshInfo

_FAMILY_MODS = {"dense": transformer, "moe": transformer, "vlm": transformer, "hybrid": hybrid,
                "ssm": xlstm, "audio": encdec}


def _generator(device: torch.device, seed: int):
    if device.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def _parameter(t: torch.Tensor, device: torch.device) -> nn.Parameter:
    return nn.Parameter(t.to(device), requires_grad=False)


def _container(node: Dict, device: torch.device, path: str) -> nn.Module:
    """The parameters under one path prefix (a dict of name segments, with
    tensors at the leaves) as nested containers: integer segments 0..n-1 a
    list, named segments a dict."""
    leaves = [isinstance(v, torch.Tensor) for v in node.values()]
    if any(leaves) and not all(leaves):
        raise ValueError(f"params under {path!r} mix tensors and sub-paths")
    if all(k.isdigit() for k in node):
        if sorted(map(int, node)) != list(range(len(node))):
            raise ValueError(f"params under {path!r} number {sorted(map(int, node))}, not 0..{len(node) - 1}")
        items = [node[str(i)] for i in range(len(node))]
        if all(leaves):
            return nn.ParameterList(_parameter(t, device) for t in items)
        return nn.ModuleList(_container(v, device, f"{path}.{i}") for i, v in enumerate(items))
    if all(leaves):
        return nn.ParameterDict({k: _parameter(t, device) for k, t in node.items()})
    return nn.ModuleDict({k: _container(v, device, f"{path}.{k}") for k, v in node.items()})


class Model(nn.Module):
    """One LM of ``cfg``'s family on ``device`` (default: the card).

    ``params`` (by state-dict name, e.g. from ``params_from_reference``)
    gives the weights; without it they are drawn from a ``torch.Generator``
    on the device seeded with ``seed`` (on ``meta``, shapes only). Tensors
    already on ``device`` are taken as they are, not copied. Parameters do
    not require grad until ``repro_torch.train.init_all`` makes the model
    trainable.
    """

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.mesh = None  # set by place_model
        self.device = resolve_device(device)
        if params is None:
            params = self.mod.init_params(cfg, _generator(self.device, seed))
        tree: Dict = {}
        for name, t in params.items():
            *path, leaf = name.split(".")
            node = tree
            for seg in path:
                node = node.setdefault(seg, {})
            node[leaf] = t
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(name, _parameter(sub, self.device))
            else:
                self.add_module(name, _container(sub, self.device, name))
        # a stack of length 0 (the reduced jamba's super-blocks) has no
        # parameters, so no name makes it: an empty list stands for it
        for name, count in self.mod.stacks(cfg).items():
            have = len(getattr(self, name)) if hasattr(self, name) else 0
            if have != count:
                raise ValueError(f"params hold {have} of {count} {name}")
            if not count:
                self.add_module(name, nn.ModuleList())

    @property
    def mod(self):
        return _FAMILY_MODS[self.cfg.family]

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
        """The parameters of ``cfg`` by state-dict name as ``meta`` tensors:
        shapes and dtypes, nothing allocated or drawn."""
        return _FAMILY_MODS[cfg.family].init_params(cfg, MetaGenerator())

    def _inputs(self, batch: Dict) -> Dict[str, torch.Tensor]:
        # pinned, asynchronous host copies: a blocking copy would wait for
        # the decode steps queued before a prefetched admission's prefill
        return {k: to_device(v, self.device) for k, v in batch.items()}

    # -------------------------------------------------------------- steps
    def train_loss(self, batch: Dict, mesh_info=None):
        batch = self._inputs(batch)
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        return self.mod.forward_train(self.cfg, self, batch["tokens"], batch["labels"], mesh_info, extras)

    def prefill(self, batch: Dict, mesh_info=None, cache_len=None):
        batch = self._inputs(batch)
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return self.mod.prefill(self.cfg, self, batch["tokens"], mesh_info, extras, cache_len)

    def decode_step(self, cache: Dict, token, mesh_info=None):
        return self.mod.decode_step(self.cfg, self, cache, to_device(token, self.device), mesh_info)

    def cache_shapes(self, batch: int, cache_len: int):
        return self.mod.cache_shapes(self.cfg, batch, cache_len)

    def input_specs(self, shape: ShapeConfig) -> Dict:
        """Every input of ``shape``'s step as ``meta`` tensors, the
        reference's keys: train ``tokens``, ``labels`` (B, S) int32; prefill
        ``tokens``; the modality stubs beside them (vlm ``patch_embeds``,
        audio ``frames``) in the model dtype; decode ``token`` (B,) int32
        and the ``cache`` of ``cache_shapes(B, S)``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def meta(dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == "decode":  # one new token against a seq_len cache
            return {"token": meta((B,)), "cache": self.cache_shapes(B, S)}
        specs = {"tokens": meta((B, S))}
        if shape.kind == "train":
            specs["labels"] = meta((B, S))
        if cfg.family == "vlm":
            specs["patch_embeds"] = meta((B, cfg.vision_tokens, cfg.d_model), dtype_of(cfg))
        if cfg.family == "audio":
            specs["frames"] = meta((B, cfg.enc_positions, cfg.d_model), dtype_of(cfg))
        return specs


def make_mesh_info(mesh, cfg: ArchConfig) -> Optional[MoEMeshInfo]:
    """How the model sees ``mesh`` (a ``DeviceMesh``): its model axis and
    its data axes (``pod`` and ``data``, and ``model`` after them under
    the ``dp`` policy)."""
    if mesh is None:
        return None
    return MoEMeshInfo(mesh=mesh, model_axis="model", data_axes=shd.dp_axes(mesh, cfg))


def model_axis_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index("model")] if "model" in names else 1


def place_model(model: Model, mesh) -> Model:
    """Place ``model``'s parameters on ``mesh`` by their sanitized
    ``param_specs``, in place: each becomes a ``DTensor`` parameter that
    keeps this rank's block of the tensor it held, which must be the same
    full tensor on every rank (the same seed, or ``convert``'s output of
    one parameter tree); nothing is sent. Under the ``dp`` policy every
    rank keeps its full replica as a plain tensor. Placing again on the
    same mesh changes nothing."""
    if getattr(model, "mesh", None) is mesh:
        return model
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already placed on another mesh")
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
    cfg = model.cfg
    if cfg.param_sharding != "dp":
        shapes = dict(model.named_parameters())
        specs = shd.sanitize_specs(mesh, shd.param_specs(cfg, shapes, model_axis_size(mesh)), shapes)
        for name, p in shapes.items():
            *path, leaf = name.split(".")
            owner = model.get_submodule(".".join(path)) if path else model
            placed = nn.Parameter(shd.place(p.detach(), mesh, specs[name]), requires_grad=p.requires_grad)
            if isinstance(owner, (nn.ParameterList, nn.ParameterDict)):
                owner[int(leaf) if isinstance(owner, nn.ParameterList) else leaf] = placed
            else:
                setattr(owner, leaf, placed)
    model.mesh = mesh
    return model
