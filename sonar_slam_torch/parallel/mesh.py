"""The device axis: SPMD ranks, one process a card, joined by a gloo group.

Counterpart of what ``jax.sharding.Mesh``, ``shard_map`` and
``jax.lax.all_gather`` give the JAX package. Every rank is one process that
drives one card (``cuda:(rank % device_count)``, or the CPU when the caller
asks for it); where there are more ranks than cards, ranks share cards. Every
rank calls the same function with the same :class:`Mesh`, computes its
contiguous block of the sharded axis (the layout of JAX's ``P(axis)``) and
all-gathers the result, so that every rank ends with the whole result in lane
order (JAX's ``out_specs=P(axis)`` global arrays).

The gathers go through gloo over host copies, which works in every layout,
several ranks on one card included (NCCL refuses two ranks on one GPU); the
gathered data are per-lane carries, per-loop results and (K, N) masks.

* :func:`spawn` starts the ranks (``torch.multiprocessing``, start method
  ``spawn``), joins them through a ``FileStore`` in a temporary directory
  (no address or port to choose; gloo's pairs then connect over the
  loopback interface), calls ``fn(mesh, *args)`` on each and
  returns rank 0's result; a rank that raises or outlives ``timeout_s``
  makes it raise. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) it
  joins that world instead.
* :func:`make_config_mesh` is the mesh of the ranks' world, called inside a
  rank; :func:`shard` cuts this rank's block; :func:`gather` all-gathers.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import threading
import time
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 3600.0
_RESULT = "rank0_result.pt"


class Mesh(NamedTuple):
    """One axis of ranks, as this rank sees it."""

    axis: str  # the axis name (JAX's mesh axis name)
    size: int  # ranks on the axis
    rank: int  # this rank
    device: torch.device  # this rank's device
    group: object  # the gloo ProcessGroup of the axis


def make_config_mesh(num_devices: int | None = None, axis: str = "config",
                     cpu: bool = False) -> Mesh:
    """The mesh of this rank's world, named ``axis``; called inside a rank
    (started by :func:`spawn` or ``torchrun``). ``num_devices`` must be the
    world size when given: no call silently runs fewer ranks. The rank's
    device is ``cuda:(rank % device_count)``, or the CPU with ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_config_mesh runs inside a rank: start the "
                           "ranks with parallel.mesh.spawn or torchrun")
    size, rank = dist.get_world_size(), dist.get_rank()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} devices asked for in a "
                         f"world of {size} ranks")
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh's ranks; pass "
                               "cpu=True to run them on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(axis=axis, size=size, rank=rank, device=device,
                group=dist.group.WORLD)


def check_axis(mesh: Mesh, axis: str | None) -> None:
    """Raise ValueError unless ``axis`` (None: the mesh's own) names the
    mesh's axis, as a JAX ``PartitionSpec`` must."""
    if axis is not None and axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's axis {mesh.axis!r}")


def check_divisible(n: int, size: int, what: str) -> None:
    """Raise ValueError unless ``size`` ranks split ``n`` into equal blocks."""
    if n % size:
        raise ValueError(f"{what} ({n}) is not divisible by the mesh size "
                         f"({size})")


def _tree(fn, x, mesh: Mesh):
    """``fn`` on every tensor of ``x`` (a tensor, or a (Named)tuple of
    tensors and ``None``), in the same structure."""
    if isinstance(x, tuple):
        vals = [_tree(fn, v, mesh) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return None if x is None else fn(x, mesh)


def shard(x, mesh: Mesh):
    """This rank's contiguous block of the leading axis of every tensor in
    ``x`` (a tensor, or a (Named)tuple of tensors and ``None``)."""
    return _tree(_shard, x, mesh)


def _shard(x, mesh: Mesh):
    check_divisible(x.shape[0], mesh.size, "the sharded axis")
    b = x.shape[0] // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def gather(x, mesh: Mesh):
    """All-gather every tensor of ``x`` (a tensor, or a (Named)tuple of
    tensors and ``None``) over the mesh: each rank's block, concatenated on
    the leading axis in rank order, on every rank. Each leaf goes to the
    host and back to its device; integer and bool leaves keep their dtype."""
    return _tree(_gather, x, mesh)


def _gather(x, mesh: Mesh):
    if x.dim() == 0:
        raise ValueError("gather needs a leading axis to concatenate on")
    host = x.detach().cpu()
    wire = host.to(torch.uint8) if host.dtype == torch.bool else host
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).to(dtype=x.dtype, device=x.device)


def ranks_per_card(num_devices: int, cpu: bool) -> int | None:
    """How many ranks share a card (None for CPU ranks)."""
    if cpu:
        return None
    return math.ceil(num_devices / torch.cuda.device_count())


def _watch_parent(ppid: int) -> None:
    """End this rank when the process that spawned it is gone (killed
    before it could stop its ranks)."""
    while os.getppid() == ppid:
        time.sleep(1.0)
    os._exit(1)


def _rank_main(rank, world, store_dir, fn, args, cpu, axis, timeout_s, ppid):
    threading.Thread(target=_watch_parent, args=(ppid,), daemon=True).start()
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_config_mesh(world, axis, cpu)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        out = fn(mesh, *args)
        if rank == 0:
            tmp = os.path.join(store_dir, _RESULT + ".tmp")
            torch.save(out, tmp)
            os.replace(tmp, os.path.join(store_dir, _RESULT))
        if not cpu:
            from ..kernels import cfar_cuda

            with open(os.path.join(store_dir, f"launches_{rank}.json"),
                      "w") as f:
                json.dump(cfar_cuda.cfar_detect.kernel_launches, f)
    finally:
        dist.destroy_process_group()


def _add_rank_launches(store_dir: str, num_devices: int) -> None:
    """Add the CFAR launches each rank made to this process's counters."""
    from ..kernels import cfar_cuda

    for rank in range(num_devices):
        with open(os.path.join(store_dir, f"launches_{rank}.json")) as f:
            for kernel, n in json.load(f).items():
                cfar_cuda.cfar_detect.kernel_launches[kernel] += n
                cfar_cuda.cfar_detect.launches += n


def spawn(fn, num_devices: int, *args, cpu: bool = False, axis: str = "config",
          timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on ``num_devices`` ranks and return rank 0's
    result (saved by ``torch.save`` and loaded here).

    ``fn`` and ``args`` are pickled by reference into the ranks: ``fn`` is a
    module-level function, and the ranks build their own inputs (from a seed
    or a path). On cards (``cpu`` False) the kernels are built here first,
    once, ranks share cards where there are more ranks than cards (said on
    stderr), and the CFAR launches the ranks made are added to this
    process's counters (``cfar_detect.launches`` and ``kernel_launches``),
    as if it had made them. A rank that raises makes this raise (the others
    are stopped), and so does a world that has not ended within
    ``timeout_s`` (also each collective's limit). Under ``torchrun`` it
    joins that world and returns this rank's own result."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != num_devices:
            raise ValueError(f"{num_devices} ranks asked for in a torchrun "
                             f"world of {os.environ['WORLD_SIZE']}")
        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timedelta(seconds=timeout_s))
        mesh = make_config_mesh(num_devices, axis, cpu)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        return fn(mesh, *args)
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh's ranks; pass "
                               "cpu=True to run them on the CPU")
        from ..kernels import cfar_cuda

        cfar_cuda.build()
        print(f"mesh: {num_devices} ranks on {torch.cuda.device_count()} "
              f"card(s), {ranks_per_card(num_devices, cpu)} rank(s) a card, "
              "gathers over gloo", file=sys.stderr, flush=True)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sonar_slam_mesh_") as store_dir:
        ctx = mp.start_processes(
            _rank_main, args=(num_devices, store_dir, fn, args, cpu, axis,
                              timeout_s, os.getpid()),
            nprocs=num_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=min(1.0, max(0.0, deadline
                                                    - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"the mesh's {num_devices} ranks had "
                                       f"not ended after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        if not cpu:
            _add_rank_launches(store_dir, num_devices)
        return torch.load(os.path.join(store_dir, _RESULT), weights_only=False)
