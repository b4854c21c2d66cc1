"""Training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 100 --batch 8 --seq 256 --ckpt-dir ckpt [--resume] [--reduced] [--device cpu]

The port of the JAX package's ``repro.launch.train``: config registry,
model, AdamW, the stateless-seeded data pipeline, checkpoint/restart and
straggler monitoring, on one device (the card unless ``--device`` names
another) or, from a program whose ranks each call :func:`train` with one
``DeviceMesh``, on that mesh: every rank builds the same seeded model,
places it (``models.place_model``) and steps on the same global batches;
checkpoints are gathered whole and written by rank 0, which alone logs.
A step's time includes its device work: the driver reads the loss back
before it stops the step's timer.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..data import synthetic_batch
from ..models import Model
from ..optim import OptConfig
from ..train import checkpoint, elastic, init_all, make_train_step
from .mesh import mesh_device


def train(
    cfg,
    *,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str | None,
    ckpt_every: int = 50,
    resume: bool = False,
    mesh=None,
    opt_cfg: OptConfig | None = None,
    log_every: int = 10,
    device=None,
):
    """Train ``cfg`` from seed 0 for ``steps`` steps on synthetic batches of
    ``batch`` × ``seq`` tokens; returns ``(params, opt_state, losses)``.
    With ``mesh`` (a ``DeviceMesh``) the model lives on this rank's device
    of it unless ``device`` names one."""
    if mesh is not None and device is None:
        device = mesh_device(mesh)
    say = mesh is None or dist.get_rank() == 0
    model = Model(cfg, device=device, seed=0)
    oc = opt_cfg or OptConfig(total_steps=steps, warmup_steps=max(steps // 20, 1))
    params, opt = init_all(model, oc, mesh)
    start = 0
    if resume and ckpt_dir and checkpoint.latest_step(ckpt_dir) is not None:
        start = checkpoint.latest_step(ckpt_dir)
        state = checkpoint.restore(ckpt_dir, start, {"params": params, "opt": opt})
        model.load_state_dict(state["params"])
        opt = state["opt"]
        if say:
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(model, oc, mesh)
    shape = ShapeConfig("cli", seq, batch, "train")
    monitor = elastic.StragglerMonitor()
    losses = []
    for step in range(start, steps):
        data = synthetic_batch(cfg, shape, step, device=model.device)
        with elastic.StepTimer() as t:
            params, opt, metrics = step_fn(params, opt, data)
            losses.append(float(metrics["loss"]))
        if monitor.record(t.seconds) and say:
            print(f"[train] step {step}: straggler threshold tripped — a real "
                  f"cluster driver would re-mesh via elastic.plan_remesh here")
        if say and (step % log_every == 0 or step == steps - 1):
            toks = batch * seq / t.seconds
            print(
                f"[train] step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} {toks:,.0f} tok/s wall {t.seconds:.6f} s",
                flush=True,
            )
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, {"params": params, "opt": opt})
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps, {"params": params, "opt": opt})
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--device", type=str, default=None, help="default: the card")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    train(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    main()
