"""The port's jamba (``models.hybrid`` through ``models.Model``) against the
JAX package's on the same weights (``params_from_reference``).

The parity cases use the reduced jamba at ``n_layers=16``: two
super-blocks of the published period 8, each with 7 Mamba sub-layers, one
attention sub-layer at slot 4, and MoE MLPs on the odd slots. The reduced
config itself keeps ``attn_period=8`` but cuts ``n_layers`` to 4, so it
has **zero** super-blocks: in the reference it is embed → final norm → LM
head with ``(0, 7, ...)`` stacked leaves, and the port copies that (one
test holds it equal, so that ``launch.train --arch jamba-1.5-large-398b
--reduced`` runs as it does in the reference).

Tolerances (``test_torch_harness``'s checks): logits, loss and aux at
1e-4 in float32 and 6e-2 in bfloat16; every float32 gradient leaf within
1e-4 of its largest magnitude; three train steps at
``test_torch_train.py``'s tolerances; greedy streams, remat against no
remat, the driver's restart and the converter's round trip exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model
from test_torch_harness import (check_convert_round_trip, check_forward, check_gradients, check_resume,
                                check_serve, check_train_steps, lm_pair)

ARCH = "jamba-1.5-large-398b"
TWO_BLOCKS = dict(n_layers=16)


@pytest.mark.parametrize("dtype,s", [("float32", 20), ("bfloat16", 10)])
def test_loss_prefill_decode_equal_reference(dtype, s):
    """bfloat16 at 10 tokens: its tolerance runs the reference op by op too."""
    check_forward(ARCH, dtype, s, **TWO_BLOCKS)


def test_gradients_equal_reference():
    check_gradients(ARCH, **TWO_BLOCKS)


def test_three_train_steps_equal_reference():
    check_train_steps(ARCH, **TWO_BLOCKS)


def test_serve_streams_equal_reference():
    check_serve(ARCH, **TWO_BLOCKS)


def test_remat_equals_no_remat_bit_for_bit():
    """Each super-block rematerialized (the reference's ``jax.checkpoint``)
    gives the gradients of no remat, bit for bit on the CPU."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32", **TWO_BLOCKS)
    model = Model(cfg, device="cpu", seed=4)
    assert model.cfg.remat
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    model.requires_grad_(True)
    runs = []
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = model.train_loss(batch)
        runs.append((loss.item(), torch.autograd.grad(loss, list(model.parameters()))))
    assert runs[0][0] == runs[1][0]
    for (name, _), a, b in zip(model.named_parameters(), runs[0][1], runs[1][1]):
        assert torch.equal(a, b), name


def test_parameter_names_and_convert_round_trip():
    """One parameter per block (attention), per block and slot (Mamba,
    dense and MoE sub-layers, the norms): named after the reference's path;
    and back to the reference's stacked tree byte for byte."""
    _, rparams, model = lm_pair(ARCH, "float32", **TWO_BLOCKS)
    blocks = rparams["blocks"]
    want = {k for k in rparams if k != "blocks"}
    want |= {f"blocks.{b}.attn.{leaf}" for leaf in blocks["attn"] for b in range(2)}
    for kind in ("mamba", "dense", "moe"):
        slots = next(iter(blocks[kind].values())).shape[1]
        want |= {f"blocks.{b}.{kind}.{j}.{leaf}" for leaf in blocks[kind] for b in range(2) for j in range(slots)}
    want |= {f"blocks.{b}.{norm}.{i}" for norm in ("attn_norm", "mlp_norm") for b in range(2) for i in range(8)}
    assert set(dict(model.named_parameters())) == want
    assert tuple(model.blocks[1]["mamba"][6]["in_proj"].shape) == tuple(np.shape(blocks["mamba"]["in_proj"])[2:])
    np.testing.assert_array_equal(model.blocks[1]["mamba"][6]["A_log"].numpy(),
                                  np.asarray(blocks["mamba"]["A_log"])[1, 6])
    check_convert_round_trip(ARCH, **TWO_BLOCKS)


def test_port_init_has_the_reference_shapes():
    """``Model(cfg)``'s own seeded init gives every leaf the reference's
    shape and dtype, slice by slice."""
    from repro_torch.core import params_from_reference

    rmodel, _, _ = lm_pair(ARCH, "bfloat16", **TWO_BLOCKS)
    import jax

    shapes = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), rmodel.param_shapes())
    want = {k: (tuple(t.shape), t.dtype) for k, t in params_from_reference(shapes, device="cpu").items()}
    model = Model(dataclasses.replace(get_arch(ARCH).reduced(), **TWO_BLOCKS), device="cpu", seed=1)
    assert {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()} == want


def test_zero_block_reduced_jamba_equals_reference(tmp_path, capsys):
    """The reduced jamba as the reference builds it: ``n_layers=4`` under
    ``attn_period=8``, so no super-block. Its stacked leaves are empty in
    the reference, and the port holds no parameter for them; loss, aux,
    prefill and decode equal the reference's, the driver trains it, and a
    resumed run equals an uninterrupted one."""
    from repro_torch.launch.train import main

    rmodel, rparams, model = lm_pair(ARCH, "float32")
    assert model.cfg.n_layers < model.cfg.attn_period
    assert np.shape(rparams["blocks"]["mamba"]["in_proj"])[:2] == (0, 7)
    assert len(model.blocks) == 0 and set(dict(model.named_parameters())) == {"embed", "final_norm", "lm_head"}
    check_forward(ARCH, "float32")
    check_gradients(ARCH)
    main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "step     1" in capsys.readouterr().out
    check_resume(tmp_path, get_arch(ARCH).reduced())


def test_model_refuses_params_of_another_depth():
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), **TWO_BLOCKS)
    params = Model(cfg, device="cpu").state_dict()
    with pytest.raises(ValueError, match="1 of 2 blocks"):
        Model(cfg, device="cpu", params={k: v for k, v in params.items() if not k.startswith("blocks.1.")})
    with pytest.raises(ValueError, match="number"):
        Model(cfg, device="cpu", params={k: v for k, v in params.items() if not k.startswith("blocks.0.mamba.3.")})
