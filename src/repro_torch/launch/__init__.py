"""Launchers of the port. ``train`` (the training driver) is ported; the
JAX package's ``mesh``, ``steps`` and ``dryrun`` wait for the port's
``torch.distributed`` runner (ROADMAP.md, queue 1 item 5)."""
