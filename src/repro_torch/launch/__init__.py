"""Launchers of the port: ``train`` (the training driver), ``steps`` (the
serving step factories), ``dryrun`` (the one-device dry-run on ``meta``
tensors) and ``mesh`` (device meshes over ``torch.distributed`` and a
local launcher of ranks). The mesh halves of ``steps`` and ``dryrun`` wait
for the DeviceMesh/DTensor half of the mesh port (ROADMAP.md, queue 1
item 6)."""
