"""Unified model API of the port.

    model = Model(cfg)                    # random weights on the card
    model = Model(cfg, device="cpu", params=params_from_reference(tree, device="cpu"))
    loss, aux = model.train_loss(batch)
    cache, logits = model.prefill(batch, cache_len=...)
    logits, cache = model.decode_step(cache, token)

``Model`` is an ``nn.Module`` that holds its parameters under the JAX
package's leaf names: ``embed``, ``layers.<i>.<leaf>`` (one
``nn.ParameterDict`` per layer in an ``nn.ModuleList``), ``final_norm``
and ``lm_head``. The families ``dense``, ``moe`` and ``vlm`` run; the
others (``hybrid``, ``ssm``, ``audio``) are not ported yet and raise. The
dry-run's ``input_specs`` and ``param_shapes`` wait for ``launch/``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.types import resolve_device, to_device
from . import transformer

_FAMILY_MODS = {"dense": transformer, "moe": transformer, "vlm": transformer}


def _parameter(t: torch.Tensor, device: torch.device) -> nn.Parameter:
    return nn.Parameter(t.to(device), requires_grad=False)


class Model(nn.Module):
    """One LM of ``cfg``'s family on ``device`` (default: the card).

    ``params`` (by state-dict name, e.g. from ``params_from_reference``)
    gives the weights; without it they are drawn from a ``torch.Generator``
    on the device seeded with ``seed``. Tensors already on ``device`` are
    taken as they are, not copied. Parameters do not require grad until
    ``repro_torch.train.init_all`` makes the model trainable.
    """

    def __init__(self, cfg: ArchConfig, *, device=None, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None) -> None:
        super().__init__()
        if cfg.family not in _FAMILY_MODS:
            raise NotImplementedError(
                f"the {cfg.family!r} family is not ported yet (ROADMAP.md, queue 1 item 3)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.mod.init_params(cfg, gen)
        layers = [{} for _ in range(cfg.n_layers)]
        for name, t in params.items():
            if name.startswith("layers."):
                _, i, leaf = name.split(".")
                layers[int(i)][leaf] = _parameter(t, self.device)
            else:
                self.register_parameter(name, _parameter(t, self.device))
        if not all(layers):
            raise ValueError(f"params hold {sum(map(bool, layers))} of {cfg.n_layers} layers")
        self.layers = nn.ModuleList(nn.ParameterDict(lp) for lp in layers)

    @property
    def mod(self):
        return _FAMILY_MODS[self.cfg.family]

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
