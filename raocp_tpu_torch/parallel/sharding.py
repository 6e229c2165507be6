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

The flat node split (JAX ``parallel/sharding.py:68-115``):
:func:`node_sharding` describes a rank's row block, :func:`shard_problem`
cuts a host-built problem into this rank's blocks plus its exchange plan
(:mod:`raocp_tpu_torch.parallel.flat`), and :func:`shard_variables` cuts a
global-layout iterate. Where JAX's GSPMD inserts reshards around every
stage op, the port reads other ranks' rows only through :func:`exchange`,
one ``all_to_all_single`` of the planned halo rows.

Counters, so a run can read what a CP step exchanges: ``ALL_REDUCES`` /
``ALL_REDUCE_BYTES`` / ``ALL_REDUCE_SECONDS`` (the all-reduces, the bytes
they reduce, the host seconds in the collective), ``EXCHANGES`` /
``EXCHANGE_BYTES`` / ``EXCHANGE_SECONDS`` (the halo exchanges, the bytes a
rank sends, the host seconds in staging and the collective), and
``GATHERS`` / ``GATHER_SECONDS``. Before a collective that stages a CUDA
tensor through the host (gloo), the rank waits for its own stream; that
wait is timed apart, in ``ALL_REDUCE_WAIT_SECONDS``,
``EXCHANGE_WAIT_SECONDS`` and ``GATHER_WAIT_SECONDS`` (nothing waits on the
CPU, or under NCCL, which stays on the stream).
"""

import dataclasses
import datetime
import math
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AXIS", "make_mesh", "initialize_distributed", "mesh_device",
           "all_reduce", "gather_rows", "exchange", "node_sharding",
           "shard_problem", "shard_variables", "reset_counters",
           "ALL_REDUCES", "ALL_REDUCE_BYTES", "ALL_REDUCE_SECONDS",
           "ALL_REDUCE_WAIT_SECONDS", "EXCHANGES", "EXCHANGE_BYTES",
           "EXCHANGE_SECONDS", "EXCHANGE_WAIT_SECONDS", "GATHERS",
           "GATHER_SECONDS", "GATHER_WAIT_SECONDS"]

AXIS = "nodes"

ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0
ALL_REDUCE_SECONDS = 0.0
ALL_REDUCE_WAIT_SECONDS = 0.0
EXCHANGES = 0
EXCHANGE_BYTES = 0
EXCHANGE_SECONDS = 0.0
EXCHANGE_WAIT_SECONDS = 0.0
GATHERS = 0
GATHER_SECONDS = 0.0
GATHER_WAIT_SECONDS = 0.0


def reset_counters() -> None:
    """Set every collective counter of this module to 0."""
    global ALL_REDUCES, ALL_REDUCE_BYTES, ALL_REDUCE_SECONDS
    global ALL_REDUCE_WAIT_SECONDS, EXCHANGES, EXCHANGE_BYTES
    global EXCHANGE_SECONDS, EXCHANGE_WAIT_SECONDS, GATHERS
    global GATHER_SECONDS, GATHER_WAIT_SECONDS
    ALL_REDUCES = ALL_REDUCE_BYTES = EXCHANGES = EXCHANGE_BYTES = GATHERS = 0
    ALL_REDUCE_SECONDS = ALL_REDUCE_WAIT_SECONDS = EXCHANGE_SECONDS = 0.0
    EXCHANGE_WAIT_SECONDS = GATHER_SECONDS = GATHER_WAIT_SECONDS = 0.0


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


def _host_staged(t: torch.Tensor, group) -> bool:
    """A collective on ``t`` goes through host memory: a CUDA tensor under
    gloo."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _stream_wait(t: torch.Tensor) -> float:
    """Wait for the work queued on ``t``'s stream; the seconds waited."""
    tic = time.perf_counter()
    torch.cuda.current_stream(t.device).synchronize()
    return time.perf_counter() - tic


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """``t`` all-reduced over ``group`` (in place; ``t`` contiguous),
    counted in ``ALL_REDUCES`` / ``ALL_REDUCE_BYTES`` /
    ``ALL_REDUCE_SECONDS`` (and ``ALL_REDUCE_WAIT_SECONDS`` for the stream
    wait before a host-staged one). Every rank receives the same bits."""
    global ALL_REDUCES, ALL_REDUCE_BYTES, ALL_REDUCE_SECONDS
    global ALL_REDUCE_WAIT_SECONDS
    if _host_staged(t, group):
        ALL_REDUCE_WAIT_SECONDS += _stream_wait(t)
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
    device tensors. Counted in ``GATHERS`` / ``GATHER_SECONDS`` /
    ``GATHER_WAIT_SECONDS``."""
    global GATHERS, GATHER_SECONDS, GATHER_WAIT_SECONDS
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(arr))
    if _host_staged(t, group):
        GATHER_WAIT_SECONDS += _stream_wait(t)
    tic = time.perf_counter()
    t = (t.cuda() if dist.get_backend(group) == "nccl" else t.cpu()) \
        .contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts).cpu().numpy()
    GATHER_SECONDS += time.perf_counter() - tic
    GATHERS += 1
    return out


def _overlap(a, b):
    """The row range shared by [a0, a1) and [b0, b1) (empty: lo == hi)."""
    lo = max(a[0], b[0])
    return lo, max(lo, min(a[1], b[1]))


def exchange(pulls, rank: int, group) -> list:
    """One halo exchange: every rank brings in the rows it reads from the
    others, for several windows at once, in one ``all_to_all_single``.

    ``pulls`` is a list of ``(pull, t)``: ``pull``
    (:class:`raocp_tpu_torch.parallel.flat.Pull`) names for every rank the
    global rows it needs (``need``) and the rows its source holds
    (``have``); ``t`` [..., rows, F] is this rank's source, whose row 0 is
    global row ``pull.have[rank][0]``. Every source shares its leading
    (lane) dims. Returns one window [..., need rows, F] per pull: the
    needed rows in order, this rank's own rows copied locally and only the
    others' sent. Under gloo a CUDA source goes through host memory (after
    a timed wait for the stream); under NCCL it stays on the device.
    Counted in ``EXCHANGES`` / ``EXCHANGE_BYTES`` (what this rank sends) /
    ``EXCHANGE_SECONDS`` / ``EXCHANGE_WAIT_SECONDS``."""
    global EXCHANGES, EXCHANGE_BYTES, EXCHANGE_SECONDS, EXCHANGE_WAIT_SECONDS
    ranks = dist.get_world_size(group)
    t0 = pulls[0][1]
    lead = tuple(t0.shape[:-2])
    lanes = math.prod(lead)
    sends, send_splits = [], [0] * ranks
    recv_splits = [0] * ranks
    for peer in range(ranks):
        if peer == rank:
            continue
        for pull, t in pulls:
            lo, hi = _overlap(pull.need[peer], pull.have[rank])
            if hi > lo:
                h = pull.have[rank][0]
                piece = t[..., lo - h:hi - h, :].reshape(-1)
                sends.append(piece)
                send_splits[peer] += piece.numel()
            lo, hi = _overlap(pull.need[rank], pull.have[peer])
            recv_splits[peer] += (hi - lo) * lanes * t.shape[-1]
    staged = _host_staged(t0, group)
    if staged:
        EXCHANGE_WAIT_SECONDS += _stream_wait(t0)
    tic = time.perf_counter()
    send = torch.cat(sends) if sends else t0.new_empty(0)
    if staged:
        send = send.cpu()
    recv = send.new_empty(sum(recv_splits))
    dist.all_to_all_single(recv, send, recv_splits, send_splits, group=group)
    if staged:
        recv = recv.to(t0.device)
    EXCHANGE_SECONDS += time.perf_counter() - tic
    EXCHANGES += 1
    EXCHANGE_BYTES += send.numel() * send.element_size()

    cursor = [sum(recv_splits[:peer]) for peer in range(ranks)]
    windows = []
    for pull, t in pulls:
        F = t.shape[-1]
        pieces = []
        for peer in range(ranks):
            lo, hi = _overlap(pull.need[rank], pull.have[peer])
            if hi <= lo:
                continue
            if peer == rank:
                h = pull.have[rank][0]
                pieces.append(t[..., lo - h:hi - h, :])
            else:
                size = (hi - lo) * lanes * F
                pieces.append(recv[cursor[peer]:cursor[peer] + size]
                              .view(lead + (hi - lo, F)))
                cursor[peer] += size
        windows.append(torch.cat(pieces, dim=-2) if len(pieces) > 1
                       else pieces[0] if pieces
                       else t.new_zeros(lead + (0, F)))
    return windows


# -- the flat node split (JAX parallel/sharding.py:37-115) --------------------

# fields whose leading axis is a node count: all-node, nonleaf or leaf rows
# (the dense offline stacks are None unless the solve reads them)
_NODE_SHARDED_FIELDS = (
    "anc", "child_idx", "child_mask", "child_rank", "nz_mask",
    "A", "B",
    "b_pad", "y_mask", "risk_free_rows", "risk_zero_rows",
    "nl_lo", "nl_hi", "nl_active", "nl_ball_c", "nl_ball_r",
    "l_lo", "l_hi", "l_active", "l_ball_c", "l_ball_r",
    "P", "Rinv", "K", "Abar", "sumAPB", "Pi", "riccati_cls",
)
# small shared matrices (None unless a Polyhedral constraint sets them)
_OPTIONAL_REPLICATED_FIELDS = ("nl_G", "l_G")
# node-leading, None unless some node's risk uses them
_OPTIONAL_NODE_SHARDED_FIELDS = ("risk_soc_rows", "risk_soc_tail")
# mode-grouped stacks: the mode table is replicated, the per-node mode
# index (or the dense per-node stack) is split
_MODAL_FIELDS = ("sqrtQ", "sqrtR", "sqrtP", "Am", "Bm", "ABm", "QRm")
_REPLICATED_FIELDS = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd",
                      "k_s", "rinv_s", "sumapb_s",
                      "k_ms", "rinv_ms", "sumapb_ms")


@dataclasses.dataclass(frozen=True)
class NodeSharding:
    """Dim 0 split in ``ranks`` equal blocks, this ``rank`` holding one,
    the other ``ndim - 1`` dims whole (JAX ``NamedSharding(mesh,
    P("nodes", None, ...))``)."""

    ranks: int
    rank: int
    ndim: int

    def block(self, rows: int) -> slice:
        """This rank's rows of a dim 0 of ``rows`` (a multiple of
        ``ranks``, else ValueError)."""
        if rows % self.ranks:
            raise ValueError(f"{rows} rows do not split evenly over "
                             f"{self.ranks} ranks: build the problem with "
                             f"pad_multiple={self.ranks}")
        size = rows // self.ranks
        return slice(self.rank * size, (self.rank + 1) * size)


def node_sharding(mesh, ndim: int) -> NodeSharding:
    """This rank's row block of an ``ndim``-dim node-leading array on
    ``mesh`` (JAX ``parallel/sharding.py:68``)."""
    return NodeSharding(ranks=mesh.size(),
                        rank=dist.get_rank(mesh.get_group(AXIS)), ndim=ndim)


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def shard_problem(sp, mesh):
    """This rank's block of a host-built
    :class:`~raocp_tpu_torch.core.stacked.StackedProblem` (JAX
    ``parallel/sharding.py:77``), on the mesh's device: the row block of
    every node-, nonleaf- and leaf-leading field (``np_pad / D``, ``nl_pad
    / D``, ``lf_pad / D`` rows), the replicated tables, and the exchange
    plan (:func:`raocp_tpu_torch.parallel.flat.flat_plan`) with the halo
    tables it reads. ``sp`` must be built with a ``pad_multiple`` that the
    rank count D divides, as the JAX package builds it with D."""
    from raocp_tpu_torch.core.modal import ModalMatrix
    from raocp_tpu_torch.parallel.flat import flat_plan

    device = mesh_device(mesh, mesh.device_type)
    group = mesh.get_group(AXIS)
    shared = {}

    def blk(arr):
        if arr is None:
            return None
        rows = node_sharding(mesh, arr.dim()).block(arr.shape[0])
        return arr[rows].to(device).contiguous()

    def replicated(t):
        """A replicated tensor on the device, uploaded once (identical
        stage blocks stay one tensor, so stage groups still form)."""
        if t is None:
            return None
        if id(t) not in shared:
            shared[id(t)] = t.to(device)
        return shared[id(t)]

    values = {}
    for name in _NODE_SHARDED_FIELDS + _OPTIONAL_NODE_SHARDED_FIELDS:
        values[name] = blk(getattr(sp, name))
    for name in _MODAL_FIELDS:
        mm = getattr(sp, name)
        values[name] = None if mm is None else ModalMatrix(
            dense_m=blk(mm.dense_m), modes=replicated(mm.modes),
            idx=blk(mm.idx))
    for name in _REPLICATED_FIELDS:
        values[name] = tuple(replicated(t) for t in getattr(sp, name))
    for name in _OPTIONAL_REPLICATED_FIELDS:
        values[name] = replicated(getattr(sp, name))
    ranks = mesh.size()
    lf_real = (torch.arange(sp.lf_pad) < sp.num_leaf).to(sp.dtype)
    values["lf_half_mask"] = blk(lf_real)
    plan = flat_plan(sp, ranks, dist.get_rank(group), device)
    return dataclasses.replace(
        sp, np_pad=sp.np_pad // ranks, nl_pad=sp.nl_pad // ranks,
        lf_pad=sp.lf_pad // ranks, spmd_group=group, spmd_ndev=ranks,
        flat=plan, **values)


def shard_variables(tree, mesh):
    """This rank's block of a global-layout ``Primal`` / ``Dual`` (or any
    NamedTuple of node-leading arrays or tensors), on the mesh's device
    (JAX ``parallel/sharding.py:113``): each leaf's dim 0, a multiple of
    the rank count, split evenly."""
    device = mesh_device(mesh, mesh.device_type)
    out = []
    for v in tree:
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(v))
        rows = node_sharding(mesh, t.dim()).block(t.shape[0])
        out.append(t[rows].to(device).contiguous())
    return type(tree)(*out)
