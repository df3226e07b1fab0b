"""Meshes — the counterpart of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches
no device and no process group.  A real mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of an
initialised process group (one rank per device);
:func:`abstract_mesh` gives the axis names and sizes alone, for planning
at production size on one card.  :func:`fake_process_group` gives a
world of any size in one process whose collectives move nothing, so
``make_production_mesh`` builds a real 256- or 512-rank DeviceMesh for
``launch.dryrun`` to trace a sharded step on.  :func:`spawn_world`
gives a real world of N processes, whose collectives move data: the
counterpart of the JAX package's ``--xla_force_host_platform_device_
count=8`` subprocess tests.  :func:`all_gather_through_all_to_all` is
the all-gather such a world's gloo ranks run on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

from repro_torch.parallel.sharding import AbstractMesh

__all__ = [
    "PRODUCTION_AXES",
    "PRODUCTION_SHAPES",
    "abstract_mesh",
    "all_gather_through_all_to_all",
    "fake_process_group",
    "make_debug_mesh",
    "make_production_mesh",
    "single_process_group",
    "spawn_world",
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


def all_gather_through_all_to_all(dispatch_key: str = "CUDA"):
    """gloo's ``all_gather_into_tensor`` on CUDA tensors kills the
    process (SIGSEGV in torch 2.11), where its ``all_to_all_single``
    runs.  This registers, for `dispatch_key`, an implementation of the
    functional all-gather (``_c10d_functional::all_gather_into_tensor``,
    the op DTensor and ``full_tensor()`` issue) that runs it as an
    ``all_to_all_single`` of the input repeated once per rank: every
    rank receives each rank's input, the same bytes an all-gather
    moves, on the same tensors.  A ``StepRecorder`` still counts the
    all-gather DTensor issued.  Returns the ``torch.library.Library``
    that holds the implementation: it is in force while that object
    lives."""
    import torch

    def all_gather_into_tensor(input, group_size, group_name):
        x = input.contiguous()
        rows = [x.shape[0]] * group_size
        return torch.ops._c10d_functional.all_to_all_single(
            x.repeat(group_size, *([1] * (x.dim() - 1))), rows, rows,
            group_name)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, dispatch_key)
    return lib


def _rank_main(rank, world_size, backend, device_type, store_path,
               timeout, results, fn, args, route_all_gather):
    """One rank of :func:`spawn_world`: join the group, run
    ``fn(rank, *args)``, put ``(rank, ok, result or traceback)`` on
    `results`.  A rank that fails reports before it leaves the group:
    the other ranks see it go only when it exits, after its report."""
    try:
        import faulthandler

        import torch
        import torch.distributed as dist

        # a crash in native code (a collective, a kernel) prints this
        # rank's Python stack before the process dies
        faulthandler.enable()
        if device_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        # held for the rank's lifetime: the registration lasts as long
        # as the library object
        shim = (all_gather_through_all_to_all() if route_all_gather
                and backend == "gloo" and device_type == "cuda" else None)
        out = fn(rank, *args)
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()
    results.put((rank, True, out))
    del shim


def spawn_world(world_size: int, fn, *args, backend: str = "gloo",
                device_type: str = "cpu", timeout: float = 300.0,
                route_all_gather: bool = True) -> list:
    """Run ``fn(rank, *args)`` on each rank of a world of `world_size`
    processes and return what each rank returned, in rank order.

    The processes start by ``spawn`` (never ``fork``: the card needs
    it), so `fn`, `args` and the results must pickle, and `fn` must be
    importable by name.  The rendezvous is a ``FileStore`` in a fresh
    temporary directory: no network, no port.  Each rank runs one CPU
    thread (``device_type="cpu"``) or takes card ``rank % count``,
    initialises the process group (`backend`), runs `fn`, and destroys
    the group.  ``gloo`` carries CUDA tensors through host memory, all
    but its all-gather, which kills the process: with ``backend="gloo"``
    and ``device_type="cuda"`` each rank first installs
    :func:`all_gather_through_all_to_all` (unless `route_all_gather` is
    false, for a probe of gloo's own all-gather).  nccl, gloo on the
    CPU and the fake group are left alone.

    When a rank raises, this raises ``RuntimeError`` with that rank's
    traceback; when a rank dies without a result, or `timeout` seconds
    pass, it raises too.  Either way every rank still running is
    terminated (then killed), so no rank is left blocked in a
    collective."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="repro_torch_world_")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            rank, world_size, backend, device_type,
            os.path.join(root, "store"), timeout, results, fn, args,
            route_all_gather))
        for rank in range(world_size)
    ]
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_world: {world_size - len(got)} of {world_size} "
                    f"ranks gave no result within {timeout:g} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a last look: its result may be in flight
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn_world: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"spawn_world: rank {rank} raised:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=5.0 if len(got) == world_size else 0.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(root, ignore_errors=True)
    return [got[r] for r in range(world_size)]
