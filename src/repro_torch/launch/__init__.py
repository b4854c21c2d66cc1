"""Launchers of the port: ``train`` (the training driver), ``steps`` (the
serving step factories) and ``dryrun`` (the one-device dry-run on ``meta``
tensors). The JAX package's ``mesh``, and the mesh halves of ``steps`` and
``dryrun``, wait for the port's ``torch.distributed`` runner (ROADMAP.md,
queue 1 item 5)."""
