"""The port's training path against the JAX package's: ``train_loss``
gradients, the train step (AdamW, microbatches), remat, the memorizable
-data criterion and the driver's restart.

Weights come from the reference's ``init(key(seed))`` through
``params_from_reference`` (``test_torch_harness.lm_pair``); inputs from
numpy seeds, handed to both packages. Tolerances:

* float32 gradients: each leaf within 1e-4 of its largest magnitude in
  the reference's gradient (measured: at most 2.6e-6).
* bfloat16 gradients, against the jitted reference (the function its
  trainer runs): each case measures, leaf by leaf, how far the
  reference's own op-by-op gradients (``jax.disable_jit``) lie from its
  jitted ones, over the leaf's largest magnitude (XLA keeps float32
  inside its fusions where an op-by-op run rounds to bfloat16, and the
  port rounds where the op-by-op run does: from 0.011 on tinyllama's
  ``w_up`` to 0.25 on the reduced granite's router). The port is a
  third bfloat16 run of the same gradient, and one draw of that spread
  is noisy: over the 63 leaves of the five cases the port's error is
  0.70–1.51 times the reference's own on the same leaf. Each leaf is held
  at twice its own spread, floored at 2 bfloat16 ulps of its largest
  magnitude and capped at 1.25 times the case's largest spread.
* three train steps, float32: the moments within 1e-4 of each leaf's
  largest magnitude; losses and gradient norms at ``rtol`` 1e-5, the
  learning rate at 2 float32 ulp. An Adam update divides by the root of
  the second moment, so where an element's gradient is all rounding noise
  the last bits move its update by up to the learning rate: every
  parameter is held within twice the sum of the steps' learning rates,
  and 999 in 1000 of each leaf's within 1e-5 of its largest magnitude
  (measured: a few elements in 10^5 exceed it, the largest by 1.2e-4 at
  a learning-rate sum of 2.9e-3).
* microbatches: float32 at the three-step tolerances against the
  reference; bfloat16 against the same step taken by hand at ``rtol``
  1e-5; the parameters within the reference's ``atol`` 5e-2 of the full
  batch's.
* remat against no remat on the CPU, and the driver's resumed run against
  an uninterrupted one: bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import opt_state_from_reference, params_from_reference, tree_to_reference
from repro_torch.models import Model
from repro_torch.optim import OptConfig
from repro_torch.train import init_all, make_train_step
from test_torch_harness import lm_pair, port_config, ref_lm, to_numpy

#: (arch, tokens a row) — granite at 128 and 768 records a layer (past 512
#: the capacity rule drops), mixtral past its window of 64, internvl2 past
#: its 16 patch tokens
CASES = [("tinyllama-1.1b", 32), ("granite-moe-1b-a400m", 32), ("granite-moe-1b-a400m", 192),
         ("mixtral-8x22b", 96), ("internvl2-76b", 40)]


def ref_train():
    import importlib

    ref_lm()
    return importlib.import_module("repro.train.train_step"), importlib.import_module("repro.optim")


def case_batch(cfg, s, b=2, seed=3):
    """numpy tokens and labels (and patch embeddings for the VLM) as
    ``(port batch, reference batch)``."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.family == "vlm":
        pe = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        rbatch["patch_embeds"] = jnp.asarray(pe).astype(cfg.dtype)
        batch["patch_embeds"] = torch.from_numpy(pe).to(getattr(torch, cfg.dtype))
    return batch, rbatch


def flat(tree) -> dict:
    """A reference-shaped tree as ``{leaf name: float32 array}``."""
    out = {k: to_numpy(v) for k, v in tree.items() if k != "layers"}
    out.update({k: to_numpy(v) for k, v in tree.get("layers", {}).items()})
    return out


def rel_errors(port: dict, ref) -> dict:
    """Each leaf's largest error over its largest magnitude in ``ref``."""
    got, want = flat(tree_to_reference(port)), flat(ref)
    assert got.keys() == want.keys()
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()) for k in want}


def bf16_ulps(ref) -> dict:
    """Each leaf's bfloat16 ulp at its largest magnitude, over that
    magnitude (bfloat16 keeps 8 significant bits)."""
    out = {}
    for k, a in flat(ref).items():
        top = float(np.abs(a).max())
        out[k] = 2.0 ** (np.floor(np.log2(top)) - 7) / top
    return out


def port_grads(model, batch):
    params, _ = init_all(model, OptConfig())
    loss, aux = model.train_loss(batch)
    g = torch.autograd.grad(loss, list(params.values()))
    return loss, aux, dict(zip(params, g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,s", CASES)
def test_train_loss_gradients_equal_reference(arch, s, dtype):
    import jax

    rmodel, rparams, model = lm_pair(arch, dtype)
    batch, rbatch = case_batch(model.cfg, s)
    loss_and_grads = jax.value_and_grad(lambda p: rmodel.train_loss(p, rbatch), has_aux=True)
    (rloss, raux), rgrads = jax.jit(loss_and_grads)(rparams)
    loss, aux, grads = port_grads(model, batch)
    assert all(g.dtype == p.dtype for g, p in zip(grads.values(), model.parameters()))
    if "overflow" in raux:
        assert bool(aux["overflow"]) == bool(raux["overflow"]) == (s * 2 * model.cfg.moe_top_k > 512)
    errs = rel_errors(grads, rgrads)
    if dtype == "float32":
        tol = dict.fromkeys(errs, 1e-4)
    else:
        with jax.disable_jit():
            own = rel_errors(params_from_reference(jax.tree.map(np.asarray, loss_and_grads(rparams)[1]),
                                                   device="cpu"), rgrads)
        tol = {k: min(2 * max(own[k], 2 * ulp), 1.25 * max(own.values()))
               for k, ulp in bf16_ulps(rgrads).items()}
    assert all(errs[k] <= tol[k] for k in errs), {k: (errs[k], tol[k]) for k in errs}
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)


@pytest.mark.parametrize("arch,s,dtype", [("granite-moe-1b-a400m", 192, "float32"),
                                          ("granite-moe-1b-a400m", 192, "bfloat16"),
                                          ("mixtral-8x22b", 96, "bfloat16")])
def test_remat_equals_no_remat_bit_for_bit(arch, s, dtype):
    """The recomputed blocks make the forward pass's routing decisions and
    round as it did: the gradients with remat are those without it, bit for
    bit on the CPU (granite with records dropped)."""
    cfg = dataclasses.replace(ref_lm().configs.get_arch(arch).reduced(), dtype=dtype)
    model = Model(port_config(cfg), device="cpu", seed=4)
    assert model.cfg.remat
    batch, _ = case_batch(model.cfg, s)
    loss, aux, g_remat = port_grads(model, batch)
    model.cfg = dataclasses.replace(model.cfg, remat=False)
    loss2, aux2, g_plain = port_grads(model, batch)
    assert loss.item() == loss2.item()
    for k in g_remat:
        assert torch.equal(g_remat[k], g_plain[k]), k
    if "overflow" in aux:
        assert bool(aux["overflow"]) == bool(aux2["overflow"]) == (s * 2 * model.cfg.moe_top_k > 512)


def port_and_reference_steps(arch, dtype, oc, microbatches=1, steps=3, s=32, seed=0):
    """``steps`` train steps in both packages from one state (the
    reference's init, its fresh AdamW state carried across): the per-step
    metrics and the final trees of both."""
    rts, ropt = ref_train()
    rmodel, rparams, model = lm_pair(arch, dtype, seed=seed)
    if microbatches > 1:
        rmodel = ref_lm().models.Model(dataclasses.replace(rmodel.cfg, microbatches=microbatches))
        model.cfg = dataclasses.replace(model.cfg, microbatches=microbatches)
    roc = ropt.OptConfig(**oc.__dict__)
    rstate = ropt.init_state(roc, rparams)
    import jax

    params, _ = init_all(model, oc)
    state = opt_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    rstep, step = rts.make_train_step(rmodel, roc, None), make_train_step(model, oc)
    rmets, mets = [], []
    for i in range(steps):
        batch, rbatch = case_batch(model.cfg, s, b=4, seed=10 + i)
        rparams, rstate, rm = rstep(rparams, rstate, rbatch)
        params, state, m = step(params, state, batch)
        rmets.append(rm)
        mets.append(m)
    return (params, state, mets), (rparams, rstate, rmets), model


def assert_steps_match(port, ref):
    """The three-step tolerances: per-step metrics, moments and parameters
    of ``port_and_reference_steps``' two runs."""
    (params, state, mets), (rparams, rstate, rmets) = port, ref
    assert int(state["step"]) == len(rmets)
    for m, rm in zip(mets, rmets):
        assert sorted(m) == sorted(rm)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=2.4e-7)
        for k in m:
            if k.startswith("aux_") and k != "aux_overflow":
                np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5, err_msg=k)
            elif k == "aux_overflow":
                assert bool(m[k]) == bool(rm[k])
    for name, errs in (("m", rel_errors(state["m"], rstate["m"])), ("v", rel_errors(state["v"], rstate["v"]))):
        assert max(errs.values()) <= 1e-4, (name, errs)
    bound = 2 * sum(float(m["lr"]) for m in rmets)
    got, want = flat(tree_to_reference(params)), flat(rparams)
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= bound and np.quantile(d, 0.999) <= 1e-5 * np.abs(want[k]).max(), (k, d.max())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_three_train_steps_equal_reference(arch):
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    port, ref, _ = port_and_reference_steps(arch, "float32", oc)
    assert_steps_match(port, ref)


def microbatch_by_hand(model, oc, batch, mb):
    """An accumulating step's expected loss, gradient norm and first
    moments, taken by hand from the model's current weights:
    ``train_loss``'s gradients on each of the batch's ``mb`` row splits,
    summed in float32 and divided by ``mb``; the moments are (1 - beta1)
    times the clipped mean (a fresh state's first step)."""
    grads, losses = None, []
    for i in range(mb):
        loss, _, g = port_grads(model, {k: torch.as_tensor(v).chunk(mb)[i] for k, v in batch.items()})
        losses.append(float(loss.detach()))
        g = {k: t.double() for k, t in g.items()}
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    grads = {k: t / mb for k, t in grads.items()}
    norm = float(sum(t.square().sum() for t in grads.values()).sqrt())
    scale = min(1.0, oc.clip_norm / norm)
    return sum(losses) / mb, norm, {k: (1 - oc.betas[0]) * scale * t for k, t in grads.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatches_equal_reference_and_full_batch(dtype):
    """``microbatches=2`` on the reduced tinyllama. float32: three steps at
    lr 1e-3 against the reference's accumulating step, at the three-step
    tolerances. bfloat16 (the reference's
    ``test_microbatch_grads_match_full_batch``, ``OptConfig()``): one step
    against the same step taken by hand (loss, gradient norm and first
    moments at ``rtol`` 1e-5: the hand sum is float64, so only the step's
    float32 rounding separates them, where a bfloat16 sum or one
    microbatch's gradient alone would differ by 1e-3 or more). Both: the
    parameters against the reference's and the full batch's at its
    ``atol`` 5e-2."""
    if dtype == "float32":
        oc, steps = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10), 3
    else:
        oc, steps = OptConfig(), 1
    port2, ref2, model = port_and_reference_steps("tinyllama-1.1b", dtype, oc, microbatches=2, steps=steps)
    (p1, _, _), _, _ = port_and_reference_steps("tinyllama-1.1b", dtype, oc, microbatches=1, steps=steps)
    (p2, s2, m2), (rp2, _, _) = port2, ref2
    if dtype == "float32":
        assert_steps_match(port2, ref2)
    else:
        _, _, hand_model = lm_pair("tinyllama-1.1b", dtype)
        batch, _ = case_batch(hand_model.cfg, 32, b=4, seed=10)
        loss, norm, m = microbatch_by_hand(hand_model, oc, batch, 2)
        np.testing.assert_allclose(float(m2[0]["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(m2[0]["grad_norm"]), norm, rtol=1e-5)
        for k, want in m.items():
            err = float((s2["m"][k].double() - want).abs().max() / want.abs().max())
            assert err <= 1e-5, (k, err)
    got, want, full = flat(tree_to_reference(p2)), flat(rp2), flat(tree_to_reference(p1))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-2, err_msg=k)
        np.testing.assert_allclose(got[k], full[k], atol=5e-2, err_msg=k)
    assert m2[0]["loss"].dtype == torch.float32


def test_loss_decreases_on_memorizable_data():
    """The reference's ``test_loss_decreases_on_memorizable_data``: the
    reduced tinyllama, one fixed batch, 15 steps at lr 1e-3; the last loss
    below 0.8 times the first."""
    from repro_torch.configs import get_arch

    model = Model(get_arch("tinyllama-1.1b").reduced(), device="cpu", seed=0)
    oc = OptConfig(lr=1e-3, total_steps=30, warmup_steps=1)
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    tokens = torch.arange(32, dtype=torch.int32)[None].repeat(4, 1)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_launch_train_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    """``launch.train.train`` on the CPU: 3 steps with a checkpoint, then a
    resumed run to step 5, give the last two losses, the parameters and
    the optimizer state of one uninterrupted 5-step run, bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train

    cfg = get_arch("granite-moe-1b-a400m").reduced()
    oc = OptConfig(total_steps=10)
    kw = dict(batch=2, seq=32, opt_cfg=oc, device="cpu", log_every=1)
    p_full, o_full, losses = train(cfg, steps=5, ckpt_dir=None, **kw)
    train(cfg, steps=3, ckpt_dir=str(tmp_path), **kw)
    p_res, o_res, tail = train(cfg, steps=5, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert "resumed from step 3" in capsys.readouterr().out
    assert tail == losses[3:]
    for k in p_full:
        assert torch.equal(p_full[k], p_res[k]), k
        assert torch.equal(o_full["m"][k], o_res["m"][k]) and torch.equal(o_full["v"][k], o_res["v"][k]), k
    assert int(o_res["step"]) == 5


def test_train_step_refuses_a_mesh_and_foreign_params():
    from repro_torch.configs import get_arch

    model = Model(get_arch("tinyllama-1.1b").reduced(), device="cpu")
    oc = OptConfig()
    params, opt = init_all(model, oc)
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(model, oc, mesh=object())
    other = {k: p.detach().clone() for k, p in params.items()}
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        make_train_step(model, oc)(other, opt, {"tokens": tokens, "labels": tokens})


def test_launch_train_defaults_to_the_card():
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(get_arch("tinyllama-1.1b").reduced(), steps=1, batch=1, seq=8, ckpt_dir=None)


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu():
    """The reduced granite in float32, one set of weights on both devices,
    batches made on the CPU: one step's gradients within 1e-4 of each
    leaf's largest magnitude, three steps' losses and gradient norms within
    1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), dtype="float32")
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device="cuda", params=cpu.state_dict())
    batch, _ = case_batch(cfg, 192, b=2)
    _, _, g_cpu = port_grads(cpu, batch)
    _, _, g_card = port_grads(card, batch)
    for k in g_cpu:
        assert (g_card[k].cpu() - g_cpu[k]).abs().max() <= 1e-4 * g_cpu[k].abs().max(), k
    runs = []
    for m in (cpu, card):
        params, opt = init_all(m, oc)
        step, out = make_train_step(m, oc), []
        for i in range(3):
            b, _ = case_batch(cfg, 32, b=4, seed=10 + i)
            params, opt, met = step(params, opt, b)
            out.append((float(met["loss"]), float(met["grad_norm"])))
        runs.append(out)
    np.testing.assert_allclose(np.array(runs[1]), np.array(runs[0]), rtol=1e-5)
