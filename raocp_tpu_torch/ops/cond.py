"""``lax.cond`` and ``lax.while_loop`` with their state on the device:
branches as conditional nodes of a captured CUDA graph, and a loop run a
period at a time, each period one graph replay.

The device loops (``accel.run_cp_anderson``, ``accel.run_cp_supermann``)
keep their branch decisions on the device. A branch is a 0-d bool tensor
and bodies that write their results in place into buffers allocated before
the branch: whatever follows reads fixed addresses, whichever body ran.

* While a CUDA graph is captured, :func:`branch` puts each body into an IF
  conditional node of the graph: one node on ``pred`` and, with a false
  body, one on its negation (IF/ELSE nodes need CUDA 12.8; two IF nodes
  need 12.4). The nodes come from ``csrc/cond.cu`` (built with ``nvcc``
  for ``sm_90a`` at first use, as K1 is, and bound with ``ctypes``): a
  one-thread kernel that sets the node's handle from the flag on the card,
  the node, and the capture of the body into the node's graph on a stream
  of its own (one a nesting depth). The body's allocations go to a memory
  pool of that capture (one a depth), kept as long as its graph. A replay
  runs the body whose condition holds and skips the other; the host reads
  nothing. (PyTorch 2.11's ``CUDAGraph`` has no ``begin_capture_to_if_node``,
  and ``torch.cond`` traces its branches, which K1's library call does not
  survive.)
* Eagerly (wherever the loop does not capture, :func:`captures`, and in a
  card's first period before its capture) it reads ``pred`` and runs one
  body: the plain version of the nodes.

A capture into a conditional node that fails raises; nothing reruns on
the host.

:class:`Periods` drives such a loop: a period of iterations at a time,
each iteration guarded by the loop's ``running`` flag, and the host reads
that flag once a period (:class:`Flags`, :func:`drive`: the plain CP
loop, ``solver._DeviceLoop``, reads its flags through the same two).

The loops time themselves. :func:`span` marks a block in any
``torch.profiler`` trace and adds its host seconds to a counter: each
graph replay (``raocp.loop.launch``), and around each :func:`drive` of
the CP and accelerated loops, their caller's ``raocp.loop.drive``. A
captured period begins and ends with a mark of the card's clock
(:meth:`Flags.mark`), which every replay writes anew; :class:`Flags`
reads a replay's two marks with its flag and counts the period's device
time and the card's idle gap before it.
"""

import contextlib
import ctypes
import time
import weakref
from pathlib import Path

import torch

from raocp_tpu_torch.ops import sweep as sweep_mod

__all__ = ["branch", "capturing", "span", "Flags", "drive", "Periods",
           "build_library", "EAGER_READS", "LAUNCHES"]

# reads of a card's tensor that an eager branch made (the first period of
# a loop, before its capture)
EAGER_READS = 0
# the set kernels of conditional nodes that replays ran (added by the
# graph's owner, from the nodes its capture recorded: ``Periods.nodes``)
LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cond.cu"
_LIB = None
_MODES = {"global": 0, "relaxed": 2}
# the capture under way (:func:`_bodies`): its mode, the pools of its
# bodies and the conditional nodes at each nesting depth
_CAPTURE = None
# the streams that capture bodies: (card, nesting depth) -> stream, made
# before a capture for up to MAX_DEPTH nested branches
_STREAMS = {}
MAX_DEPTH = 4
# the nesting depth of the body being captured
_DEPTH = 0


def build_library() -> Path:
    """Compile ``csrc/cond.cu`` into ``build/raocp_tpu_torch/`` (as K1's
    library, keyed by a hash of the source and flags) unless it exists."""
    return sweep_mod.build_library(_SOURCE)


def _library():
    """The loaded conditional-node library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raocp_if_begin.argtypes = [p, p, i, p, i]
        lib.raocp_if_begin.restype = i
        lib.raocp_if_end.argtypes = [p]
        lib.raocp_if_end.restype = i
        lib.raocp_mark.argtypes = [p, p]
        lib.raocp_mark.restype = i
        lib.raocp_cond_error_string.argtypes = [i]
        lib.raocp_cond_error_string.restype = ctypes.c_char_p
        lib.raocp_cond_init.restype = i
        _LIB = lib
        _check(lib.raocp_cond_init(), "the conditional-node library's start")
    return _LIB


def _check(err: int, what: str):
    if err != 0:
        msg = _library().raocp_cond_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def captures(sp) -> bool:
    """Whether the device loops on the problem ``sp`` capture their periods
    as CUDA graphs: on a single device on a card. Anything else runs the
    same periods eagerly: the CPU, and a partition, whose collectives are
    staged on the host (a graph cannot capture them; eagerly each branch
    reads an all-reduced predicate, the same on every rank)."""
    return sp.device.type == "cuda" and sp.spmd_group is None


def capturing(t: torch.Tensor) -> bool:
    """Whether a CUDA graph is being captured on the current stream of
    ``t``'s card (never on the CPU)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _pool_calls():
    """PyTorch's private calls that route the current stream's allocations
    to a memory pool, end that, and release the pool (CUDA graph trees use
    them)."""
    c = torch._C
    return (c._cuda_beginAllocateCurrentStreamToPool,
            c._cuda_endAllocateToPool, c._cuda_releasePool)


@contextlib.contextmanager
def _bodies(device: torch.device, mode: str, inline: bool = False):
    """The block captures a graph whose branches are conditional nodes:
    each nesting depth's bodies capture on a stream of their own, whose
    allocations go to a pool of the capture. Yields the capture's record:
    its pools (the caller releases them with :func:`_release` once the
    graph goes) and its conditional nodes a depth. With ``inline`` every
    branch captures both bodies one after the other on the capturing
    stream, no node (the warm-up capture: a body that cannot be captured
    fails there, before any conditional node holds half of it)."""
    global _CAPTURE
    _library()
    for depth in range(MAX_DEPTH):
        if (device.index, depth) not in _STREAMS:
            _STREAMS[(device.index, depth)] = torch.cuda.Stream(device)
    record = dict(device=device, mode=_MODES[mode], pools=[], nodes=[],
                  inline=inline)
    _CAPTURE = record
    try:
        yield record
    finally:
        _CAPTURE = None
        _, end, _ = _pool_calls()
        for pool in record["pools"]:
            end(device.index, pool)


def _release(device: torch.device, pools):
    _, _, release = _pool_calls()
    for pool in pools:
        release(device.index, pool)


def _body_stream(depth: int) -> torch.cuda.Stream:
    """The stream of depth ``depth``'s bodies in the capture under way;
    its allocations routed to the capture's pool for that depth."""
    record = _CAPTURE
    if record is None:
        raise RuntimeError("a branch under capture needs cond.Periods (its "
                           "bodies' streams and pools)")
    device = record["device"]
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"branches nest deeper than {MAX_DEPTH}")
    stream = _STREAMS[(device.index, depth)]
    if depth == len(record["pools"]):
        begin, _, _ = _pool_calls()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(stream):
            begin(device.index, pool)
        record["pools"].append(pool)
        record["nodes"].append(0)
    return stream


@contextlib.contextmanager
def _if_node(pred: torch.Tensor, negate: bool):
    """Capture the block into an IF node of the graph being captured on
    the current stream, run by a replay where ``pred`` (a 0-d bool tensor
    on the card), or with ``negate`` its negation, holds."""
    global _DEPTH
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise TypeError("a branch takes a 0-d bool tensor")
    depth = _DEPTH
    body = _body_stream(depth)
    parent = torch.cuda.current_stream(pred.device)
    lib = _library()
    _check(lib.raocp_if_begin(parent.cuda_stream, pred.data_ptr(),
                              int(negate), body.cuda_stream,
                              _CAPTURE["mode"]),
           "a conditional node's capture")
    _CAPTURE["nodes"][depth] += 1
    _DEPTH += 1
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        _DEPTH -= 1
    # A body that raised is left capturing: the end of the graph's capture
    # then fails and raises (ending the failed body's capture first made
    # the process crash there, on an H100 with CUDA 12.8).
    _check(lib.raocp_if_end(body.cuda_stream),
           "the end of a conditional node's capture")


def branch(pred: torch.Tensor, true_fn, false_fn=None) -> None:
    """``true_fn()`` where the 0-d bool tensor ``pred`` holds, else
    ``false_fn()`` (if given). Both bodies return nothing: they write in
    place into buffers allocated before the call. Under capture, an IF node
    on ``pred`` and one on its negation; eagerly, one read of ``pred`` and
    one body."""
    global EAGER_READS
    if capturing(pred):
        if _CAPTURE is not None and _CAPTURE["inline"]:
            true_fn()
            if false_fn is not None:
                false_fn()
            return
        with _if_node(pred, False):
            true_fn()
        if false_fn is not None:
            with _if_node(pred, True):
                false_fn()
        return
    EAGER_READS += pred.is_cuda
    if bool(pred):
        true_fn()
    elif false_fn is not None:
        false_fn()


@contextlib.contextmanager
def span(name: str, counts: dict, key: str):
    """The block as the span ``name`` of a ``torch.profiler`` trace (on the
    clock of the trace's device events), its host seconds added to
    ``counts[key]``, also where it raises."""
    tic = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        counts[key] += time.perf_counter() - tic


class Flags:
    """The running flags of a loop's last two periods as the host reads
    them: on a card each period's flag is copied to pinned memory behind
    an event (the host waits for that period alone); on the CPU a copy.

    On a card a captured period starts and ends with :meth:`mark`, a
    one-thread kernel (``csrc/cond.cu``) that writes the card's clock into
    a slot of two. A replay's slots are copied out behind it with its flag
    (the next replay writes them anew), and the read of its flag adds to
    ``counts`` the period's device seconds (``period_device_seconds``),
    the card's seconds since the end of the replay before it in the same
    call (``gap_device_seconds``; none before a call's first) and one to
    ``timed_periods``. The period enqueued past the flag that stopped a
    loop is never read, so never timed. Only ``marked`` flags (a loop
    that captures) load the mark's library and hold the slot and stamps;
    the others time nothing."""

    def __init__(self, device: torch.device, counts: dict, shape=(),
                 marked: bool = False):
        self.cuda = device.type == "cuda"
        self.counts = counts
        self.flags = [None, None]
        self.timed = [False, False]
        self.last_end = None
        if self.cuda:
            self.flags = [torch.empty(shape, dtype=torch.bool,
                                      pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
            if marked:
                _library()              # loaded outside any capture
                self.slot = torch.zeros(2, dtype=torch.int64, device=device)
                self.stamps = torch.zeros((2, 2), dtype=torch.int64,
                                          pin_memory=True)

    def mark(self, i: int):
        """Under capture: a node that writes the card's clock (ns) into
        slot ``i`` (0 the period's start, 1 its end)."""
        stream = torch.cuda.current_stream(self.slot.device)
        _check(_library().raocp_mark(stream.cuda_stream,
                                     self.slot[i].data_ptr()),
               "a clock mark's launch")

    def post(self, n: int, running: torch.Tensor, timed: bool):
        """Period ``n``'s flag, enqueued after the period; with ``timed``
        (a replay) its marks too."""
        self.timed[n % 2] = timed
        if self.cuda:
            self.flags[n % 2].copy_(running, non_blocking=True)
            if timed:
                self.stamps[n % 2].copy_(self.slot, non_blocking=True)
            self.events[n % 2].record()
        else:
            self.flags[n % 2] = running.clone()

    def read(self, n: int) -> torch.Tensor:
        """Period ``n``'s flag on the host (a CPU tensor), a replay's marks
        counted."""
        last, self.last_end = self.last_end, None
        if self.cuda:
            self.events[n % 2].synchronize()
        if self.timed[n % 2]:
            start, end = self.stamps[n % 2].tolist()
            self.counts["period_device_seconds"] += 1e-9 * (end - start)
            if n > 0 and last is not None:
                self.counts["gap_device_seconds"] += 1e-9 * (start - last)
            self.counts["timed_periods"] += 1
            self.last_end = end
        return self.flags[n % 2]


def drive(launch, flag, most: int, ahead: int, after=None):
    """The host's side of a device loop: ``launch(n)`` enqueues period
    ``n`` (at most ``most``), ``ahead`` of them ahead of the flag read,
    ``flag(n)`` reads whether the loop still runs after period ``n``, and
    ``after(n)`` (if given) follows each read. Returns (the periods whose
    flag was read, the periods enqueued, whether a flag stopped the
    loop)."""
    launched = 0
    for n in range(most):
        while launched < min(n + 1 + ahead, most):
            launch(launched)
            launched += 1
        running = flag(n)
        if after is not None:
            after(n)
        if not running:
            return n + 1, launched, True
    return most, launched, False


class Periods:
    """A loop whose state lives on the device (the JAX package's
    ``while_loop``), run a period at a time. ``period(*args)`` runs one
    period of iterations in place, each a no-op once the 0-d bool buffer
    ``running`` is false (under :func:`branch`, or a ``torch.where`` mask),
    and leaves ``running`` holding the loop's condition. ``args`` come
    with each call (:meth:`run`), so a cached loop keeps no reference to
    them.

    With ``graph`` (:func:`captures`: a single device on a card) the
    first period runs eagerly (it builds K1's library, packs its weights,
    makes the cuBLAS and cuSOLVER handles and grows the allocator outside
    any graph: a library's first call inside a body does not survive the
    capture), a relaxed capture of a period
    that is thrown away then meets every body once, both sides of each
    branch one after the other and no conditional node (the side that the
    eager period did not take is met there; a body that cannot be
    captured fails there, and the capture raises as a plain one does,
    where a conditional node half captured could crash the process), and
    a period is captured as one CUDA graph, between two marks of the
    card's clock (:class:`Flags`), that every later period replays.
    Without ``graph`` each period is enqueued eagerly. The host reads each
    period's flag through :class:`Flags`, ``lookahead`` periods enqueued
    ahead of the read (:func:`drive`).

    ``counts`` takes the periods and host reads; with ``graph``, also the
    replays, captures, capture and launch seconds and the marks' device
    seconds and timed periods. The one rule for a counts dict: it holds
    the key of everything its loop can run, and lacks the rest (the power
    iteration's, run without a graph, has no key of a replay; its caller
    times no drive). After the capture :attr:`recorded` is the K1 calls
    the graph holds (what a replay would launch were every guard true)
    and :attr:`nodes` its conditional nodes a nesting depth."""

    def __init__(self, device: torch.device, period, running: torch.Tensor,
                 graph: bool, counts: dict):
        self.device = device
        self.period = period
        self.running = running
        self.use_graph = graph
        self.counts = counts
        self.graph = None
        self.recorded = 0
        self.nodes = []
        self.flags = Flags(device, counts, marked=self.use_graph)

    def _capture(self, graph, stream, mode, args, inline=False):
        with _bodies(self.device, mode, inline) as record, \
                torch.cuda.graph(graph, stream=stream,
                                 capture_error_mode=mode):
            self.flags.mark(0)
            self.period(*args)
            self.flags.mark(1)
        return record

    def capture(self, *args):
        """The eager first period, the warm-up capture and the period's
        graph, on a side stream."""
        tic = time.perf_counter()
        reads = EAGER_READS
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.period(*args)
        current.wait_stream(side)
        recorded = sweep_mod.RECORDED
        self._capture(torch.cuda.CUDAGraph(), side, "relaxed", args,
                      inline=True)
        # the warm-up graph never runs
        sweep_mod.RECORDED = recorded
        graph = torch.cuda.CUDAGraph()
        record = self._capture(graph, side, "global", args)
        weakref.finalize(self, _release, self.device, record["pools"])
        self.recorded = sweep_mod.RECORDED - recorded
        self.nodes = record["nodes"]
        self.graph = graph
        self.counts["captures"] += 1
        self.counts["capture_seconds"] += time.perf_counter() - tic
        self.counts["host_reads"] += EAGER_READS - reads

    def launch(self, n: int, *args):
        """Period ``n``: a replay (the span ``raocp.loop.launch``), on a
        card's first use its capture (the eager first period), or eagerly;
        then its flag."""
        replay = self.graph is not None
        if not self.use_graph:
            self.period(*args)
        elif not replay:
            self.capture(*args)
        else:
            with span("raocp.loop.launch", self.counts, "launch_seconds"):
                self.graph.replay()
            self.counts["replays"] += 1
        self.counts["periods"] += 1
        self.flags.post(n, self.running, timed=replay)

    def flag(self, n: int) -> bool:
        """Period ``n``'s running flag, as the host reads it."""
        self.counts["host_reads"] += 1
        return bool(self.flags.read(n))

    def run(self, most: int, lookahead: int, *args) -> int:
        """Periods until the flag is false (at most ``most``; the loop's own
        cap must stop it by then), ``lookahead`` of them enqueued ahead of
        the flag read. Returns the periods enqueued."""
        _, launched, stopped = drive(lambda n: self.launch(n, *args),
                                     self.flag, most, lookahead)
        if not stopped:
            raise RuntimeError(f"the loop still ran after {most} periods")
        return launched
