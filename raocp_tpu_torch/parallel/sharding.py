"""The process mesh of a partitioned solve, and the collectives the solver
runs over it (counterpart of :mod:`raocp_tpu.parallel.sharding`).

The JAX package drives every device from one process (``shard_map``); this
port runs SPMD instead: one process per rank, launched as ``torchrun``
launches it, every rank building the same :class:`~raocp_tpu_torch.Solver`
and holding only its own block of the problem. Ranks exchange data only
through :func:`all_reduce` and :func:`gather_rows` on the mesh's process
group.

The backend is the caller's choice (:func:`initialize_distributed`):
``"nccl"`` with one card a rank, or ``"gloo"``, which also runs ranks that
share one card (NCCL refuses two ranks on one device) and ranks on the CPU.
Gloo reduces CUDA tensors by staging them through host memory itself; it
gathers only host tensors, so :func:`gather_rows` gathers on the host under
gloo and on the device under NCCL.

``ALL_REDUCES``, ``ALL_REDUCE_BYTES`` and ``ALL_REDUCE_SECONDS`` count the
all-reduces, the bytes they reduce and the host seconds spent in them, so a
run can read what a CP step exchanges.

The flat node split (``node_sharding``, ``shard_problem``,
``shard_variables``) is not ported: ROADMAP.md queue 1 item 14b.
"""

import datetime
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXIS", "make_mesh", "initialize_distributed", "mesh_device",
           "all_reduce", "gather_rows", "ALL_REDUCES", "ALL_REDUCE_BYTES",
           "ALL_REDUCE_SECONDS"]

AXIS = "nodes"

ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0
ALL_REDUCE_SECONDS = 0.0


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: float = 60.0) -> int:
    """Join the process group of a partitioned solve (JAX
    ``parallel/sharding.py:119``); returns the world size.

    ``backend`` is the caller's (``"nccl"`` or ``"gloo"``); nothing
    switches it. ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and
    ``RANK`` from the environment, and ``init_method`` to ``env://``
    (``MASTER_ADDR`` and ``MASTER_PORT``), as ``torchrun`` sets them. On a
    machine with cards the rank takes card ``LOCAL_RANK`` (else ``rank``)
    modulo the card count as its current device. ``timeout`` (seconds)
    bounds every collective, so a rank that fails cannot leave the others
    blocked for long. Does nothing when a group is already initialised.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return dist.get_world_size()


def make_mesh(device_type: str = "cuda", num_devices: Optional[int] = None):
    """A 1-D ``DeviceMesh`` named ``"nodes"`` over every rank of the world
    (JAX ``parallel/sharding.py:58``). ``num_devices`` other than the world
    size raises: each rank is one process, so the mesh is the world."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: the mesh spans the "
                         f"world's {world} ranks (one process a rank)")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh, device="cuda") -> torch.device:
    """The device a rank of ``mesh`` works on: ``cuda:{current device}``
    on a CUDA mesh, the CPU on a CPU mesh. A ``device`` of another type, or
    another card, raises."""
    if mesh.device_type == "cuda":
        want = torch.device("cuda", torch.cuda.current_device())
    else:
        want = torch.device(mesh.device_type)
    asked = torch.device(device)
    if asked.type != want.type or (asked.index is not None
                                   and asked.index != want.index):
        raise ValueError(f"device={device!r} conflicts with the mesh's "
                         f"device {want}")
    return want


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` all-reduced over ``group`` (in place; ``t`` contiguous),
    counted in ``ALL_REDUCES`` / ``ALL_REDUCE_BYTES`` /
    ``ALL_REDUCE_SECONDS``. Every rank receives the same bits."""
    global ALL_REDUCES, ALL_REDUCE_BYTES, ALL_REDUCE_SECONDS
    tic = time.perf_counter()
    dist.all_reduce(t, op=op, group=group)
    ALL_REDUCE_SECONDS += time.perf_counter() - tic
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += t.numel() * t.element_size()
    return t


def gather_rows(arr, group) -> np.ndarray:
    """Every rank's block of ``arr`` (a tensor or an array, the same shape
    on every rank) stacked along rows in rank order, as NumPy: the
    [ranks * rows, ...] block layout. Gloo gathers host tensors, NCCL
    device tensors."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(arr))
    t = (t.cuda() if dist.get_backend(group) == "nccl" else t.cpu()) \
        .contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).cpu().numpy()
