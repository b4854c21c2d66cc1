"""Device meshes over ``torch.distributed``, and a local launcher of ranks.

The port of the JAX package's ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over an initialized process
group: each rank holds one position of it, and each named axis has a
process group of its own (``mesh.get_group(axis)``), which the sharded
sort and the MoE's expert-parallel paths take as their processor group.
Functions, not module constants, so importing this module touches no
process group.

Axes: ``pod`` (pure data parallelism across pods), ``data`` (data
parallelism), ``model`` (expert and tensor parallelism).

:func:`spawn` starts ``n`` ranks on this host, the port's counterpart of
the JAX package's ``--xla_force_host_platform_device_count``: the ranks
meet on a ``FileStore`` in a temporary directory (no TCP port is taken),
over ``gloo`` or ``nccl``, each on the card unless the caller asks for
the CPU (``cuda`` means ``cuda:{rank % device_count}``: every rank of a
one-card machine shares ``cuda:0``). :func:`mesh_device` gives a rank its
device in a mesh. :func:`fake_world` is the dry-run's: one process as
rank 0 of the production mesh's 256 or 512 ranks.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.types import resolve_device

__all__ = ["fake_world", "host_device_mesh", "make_mesh", "make_production_mesh", "mesh_device", "spawn"]


def _device_type(device_type: Optional[str]) -> str:
    """The device type of a mesh or of spawned ranks: the card unless the
    caller names one."""
    return device_type if device_type is not None else resolve_device(None).type


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: the card :func:`spawn` set current
    for a CUDA mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over every rank of the world, in
    rank order (tests, elastic re-meshing)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device_type), tuple(shape), mesh_dim_names=tuple(axes))


def host_device_mesh(n: int, axis: str = "data"):
    """A one-axis mesh over the first ``n`` ranks, on the host's CPU
    (distributed tests)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(n), mesh_dim_names=(axis,))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The production mesh: (data=16, model=16), or (pod=2, data=16,
    model=16). A world smaller than that raises; a larger one gives its
    first ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}; the world has {world}")
    if world == n:
        return make_mesh(shape, axes, device_type)
    return DeviceMesh(_device_type(device_type), torch.arange(n).reshape(shape), mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a world of ``n`` ranks that do not exist:
    torch's ``fake`` backend, whose collectives return at once and move
    nothing. It is the dry-run's, by design (as the ``meta`` device is): a
    step traced on ``meta`` tensors in it dispatches one rank's local ops
    and collectives, which the roofline counts. Nothing else uses it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, n: int, backend: str, device: str, root: str, args: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)
    else:
        # the rank's card, current for mesh_device; a DeviceMesh that sets
        # the card itself reads LOCAL_RANK as a card index
        card = rank % torch.cuda.device_count()
        os.environ["LOCAL_RANK"] = str(card)
        torch.cuda.set_device(card)
        torch.cuda.init()
    store = dist.FileStore(os.path.join(root, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        out = fn(rank, n, *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *, backend: str = "gloo", device: Optional[str] = None, args: tuple = ()) -> List:
    """Run ``fn(rank, n, *args)`` in ``n`` new processes (start method
    ``spawn``), each a rank of one process group, and return what each
    returned, in rank order (saved with ``torch.save``: keep it to host
    tensors and plain values).

    ``device`` is ``"cuda"`` or ``"cpu"``; None is the card, and raises
    where there is none (:func:`~repro_torch.core.types.resolve_device`).

    ``fn`` must be importable by the new processes (a module-level
    function). A rank that raises makes this raise, after every rank has
    ended; ``torch.multiprocessing`` ends the others.
    """
    import torch.multiprocessing as mp

    device = _device_type(device)
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as root:
        mp.spawn(_rank_main, args=(fn, n, backend, device, root, args), nprocs=n, join=True)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(n)]
