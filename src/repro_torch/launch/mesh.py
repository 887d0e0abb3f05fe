"""Meshes over the initialised process group, and the local launcher
that runs one program on several ranks — the counterpart of
``repro/launch/mesh.py``'s ``make_debug_mesh`` (the reference forces
host devices with ``XLA_FLAGS``; here each rank is a process).

``make_debug_mesh(shape, axes)`` lays ranks ``0 … prod(shape) - 1`` out
row-major on a ``DeviceMesh``: ``"cpu"`` under gloo, ``"cuda"`` under
NCCL. ``spawn_ranks(fn, world, *args, backend=, init_file=,
timeout_s=)`` starts ``world`` spawned processes, each of which joins
the process group (``file://`` rendezvous at ``init_file``; the
backend's timeout is the deadline), runs ``fn(rank, world, *args)`` and
leaves the group. The caller waits until every rank has exited 0; a
rank that fails, or a deadline that passes (a hung collective), kills
the rest and raises. ``make_production_mesh`` goes with the auxiliary
workloads (ROADMAP A11).
"""

from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import multiprocessing.connection
import pickle
import time

import torch
import torch.distributed as dist

__all__ = ["make_debug_mesh", "spawn_ranks"]


def make_debug_mesh(shape=(2, 4), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks ``0 …
    prod(shape) - 1`` of the initialised process group."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..dist.sharding import mesh_device_type

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() < n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the process group has {have}")
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def _rank_main(rank: int, world: int, backend: str, init_file: str, timeout_s: float) -> None:
    with open(f"{init_file}.args", "rb") as f:
        fn, args = pickle.load(f)  # written by spawn_ranks, this program's own bytes
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str, init_file, timeout_s: float) -> float:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks (``fn``
    and ``args`` are pickled: a module-level function, plain data) →
    the seconds until every rank had exited 0. ``init_file`` must not
    exist yet (the pickled program is written beside it, as
    ``<init_file>.args``). Raises ``RuntimeError`` naming the exit codes when a rank
    fails, ``TimeoutError`` past ``timeout_s``; either way no rank is
    left running."""
    ctx = mp.get_context("spawn")
    t0 = time.monotonic()
    # the program goes through a file, not each child's start-up pipe: a
    # pipe holds 64 KiB, so larger arguments would start the ranks one by
    # one, each after the one before had imported and read them
    with open(f"{init_file}.args", "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, str(init_file), timeout_s))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise RuntimeError(f"{getattr(fn, '__name__', fn)}: a rank failed; exit codes "
                                   f"{codes} (None: still running, killed)")
            if all(c == 0 for c in codes):
                return time.monotonic() - t0
            left = t0 + timeout_s - time.monotonic()
            if left <= 0:
                running = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}: ranks {running} still "
                                   f"running after {timeout_s:.0f}s (a hung collective?); "
                                   f"killed")
            mp.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                               timeout=min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(10)
