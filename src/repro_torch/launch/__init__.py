"""Launchers of the port: ``train`` (the training driver, on one device or
a ``DeviceMesh``), ``steps`` (the serving step factories, with or without
a mesh), ``dryrun`` (the dry-run on ``meta`` tensors, on one device or as
rank 0 of the production mesh in a fake world) and ``mesh`` (device
meshes over ``torch.distributed``, a local launcher of ranks, and the
dry-run's fake world)."""
