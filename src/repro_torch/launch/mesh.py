"""Meshes — the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches
no device and no process group.  A real mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group (one rank per device);
:func:`abstract_mesh` gives the axis names and sizes alone, for planning
at production size on one card.  :func:`fake_process_group` gives a
world of any size in one process whose collectives move nothing, so
``make_production_mesh`` builds a real 256- or 512-rank DeviceMesh for
``launch.dryrun`` to trace a sharded step on.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

from repro_torch.parallel.sharding import AbstractMesh

__all__ = [
    "PRODUCTION_AXES",
    "PRODUCTION_SHAPES",
    "abstract_mesh",
    "fake_process_group",
    "make_debug_mesh",
    "make_production_mesh",
    "single_process_group",
]

# the JAX package's production meshes: 16 x 16 per pod, two pods
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def abstract_mesh(shape=(16, 16), axes=("data", "model")) -> AbstractMesh:
    """Axis names and sizes without devices: the sharding functions plan
    against it as against a DeviceMesh of that shape."""
    return AbstractMesh(tuple(shape), tuple(axes))


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A small DeviceMesh over the process group's ranks (their product
    must be the world size; a world of 1 takes (1, 1) or (1, 1, 1))."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production DeviceMesh: 16 x 16 = 256 ranks, or with
    ``multi_pod`` a leading 2-pod data-parallel axis (512 ranks).
    Raises unless the process group holds exactly that many ranks."""
    import torch.distributed as dist

    shape = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a process group of {need} "
            f"ranks, this one has {world or 'none'}; plan against "
            f"abstract_mesh({shape}, {PRODUCTION_AXES[multi_pod]}) instead")
    return make_debug_mesh(shape, PRODUCTION_AXES[multi_pod], device_type)


@contextlib.contextmanager
def single_process_group(backend: str):
    """A world of one rank for the block (``gloo`` on the CPU, ``nccl``
    on the card), rendezvous through a ``FileStore`` in a temporary
    directory: no network.  The group is destroyed and the directory
    removed at the end."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    root = tempfile.mkdtemp(prefix="repro_torch_pg_")
    try:
        store = dist.FileStore(os.path.join(root, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A world of ``world_size`` ranks held by this one process as rank 0,
    for the block: torch's ``FakeProcessGroup``, whose collectives
    return at once and move nothing (registered as the ``fake`` backend
    when it is not yet).  No store is contacted and no other process
    starts.  Refuses to nest, as :func:`single_process_group` does; the
    group is destroyed at the end."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    # importing it registers the "fake" backend and gives its store
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()
