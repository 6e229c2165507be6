"""K1: the dynamics-projection DP sweeps as a hand-written CUDA kernel.

Counterpart of :mod:`raocp_tpu.ops.pallas_sweep` (the Pallas TPU kernel
``_sweep_kernel``). The projection of (x, u) onto the dynamics subspace
(reference ``cache.py:259-288``) is a backward stage recursion followed by
a forward rollout. On trees whose every nonleaf stage is stage-constant
(:func:`sweep_eligible`), :func:`project_dynamics_sweep` runs it through
``csrc/sweep.cu`` (built with ``nvcc`` for ``sm_90a`` at first use and
bound with ``ctypes``).

* CUDA tensors: the kernel runs, or the call raises. There is no fallback.
  A launch the CUDA runtime refuses or faults raises :class:`DeviceFault`.
* CPU tensors: :func:`project_dynamics_sweep_ref`, the plain torch version
  of exactly the kernel's math, runs instead.

A stage step is a chain of register-tiled skinny products over a tile of
rows, the stage's weights streamed through shared memory by bulk copies
that a producer warp starts. The launches of one apply are planned here,
where a test can see them (:func:`sweep_schedule`): the stages at the top
of the tree, too small to be worth a launch each, run up to the root and
down again in one single-block "apex" launch; every other stage runs one
launch in each direction, its rows dealt evenly to one block an SM.
:func:`sweep_work` counts the operations and the compulsory bytes of one
apply.

A batch of B solves (``Solver.solve_batch``) hands the sweep x [B, np_pad,
n], u [B, nl_pad, m] and x0 [B, n], lane-major: the lanes share the stage
weights, and one apply of all lanes is one launch set, whose stage launches
run the B * rows rows of a stage (a row's lane and node are recomputed from
its index where it is loaded or stored) and whose apex runs one block a
lane.

``LAUNCHES`` counts the calls that launched the kernel, so a run can show
that its main path went through it. A call made while a CUDA graph is
captured launches nothing: it counts in ``RECORDED``, and the graph's
owner adds its launches to ``LAUNCHES`` at each replay (the solver's
device loop). Inside :func:`stage_path` the dispatch
of ``prox.project_dynamics`` takes the torch stage path on every tree: the
switch of an A/B of K1 against it (``scripts/bench_sweep.py``).
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import weakref
from pathlib import Path

import torch

__all__ = ["sweep_eligible", "project_dynamics_sweep",
           "project_dynamics_sweep_ref", "sweep_schedule", "plan_sweep",
           "sweep_work", "build_library", "stage_path", "DeviceFault",
           "LAUNCHES", "RECORDED", "MAX_SMEM"]

LAUNCHES = 0
RECORDED = 0
# set only inside stage_path()
_STAGE_PATH = False

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raocp_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_LIB = None


class DeviceFault(RuntimeError):
    """The CUDA runtime refused or faulted a launch of the sweep kernel."""


def _fits(sp) -> bool:
    """The structural gate: every nonleaf stage has a stage-stacked
    [A | B] block and stage-constant Riccati tables, and the problem holds
    whole stages (not a rank's block of the flat partition, which runs the
    torch stage path with its halo exchanges, as the JAX package's flat
    partition runs no Pallas kernel)."""
    return (sp.flat is None
            and all(w is not None for w in sp.ab_bwd)
            and all(k is not None for k in sp.k_s))


def sweep_eligible(sp) -> bool:
    """Whether ``prox.project_dynamics`` hands ``sp`` to the kernel: the
    structural gate holds, outside :func:`stage_path`."""
    return not _STAGE_PATH and _fits(sp)


@contextlib.contextmanager
def stage_path():
    """Within the block, :func:`sweep_eligible` is false for every problem,
    so ``prox.project_dynamics`` runs the torch stage path: the switch of
    an A/B of whole loops (``scripts/bench_sweep.py``), the counterpart of
    the JAX package's ``RAOCP_TPU_PALLAS=0``. The previous state returns
    on exit, also on an exception. Only the A/B scripts use it."""
    global _STAGE_PATH
    saved = _STAGE_PATH
    _STAGE_PATH = True
    try:
        yield
    finally:
        _STAGE_PATH = saved


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("building the sweep kernel needs the CUDA "
                           "toolkit (nvcc); none was found")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library(source: Path = _SOURCE) -> Path:
    """Compile ``source`` (``csrc/sweep.cu`` by default) into
    ``build/raocp_tpu_torch/`` (keyed by a hash of the source and flags)
    unless that library exists; return its path. A failed build raises
    with nvcc's output."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"{source.stem}_{key[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)            # atomic: concurrent builds agree
    return lib


def _library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.raocp_sweep_f32, lib.raocp_sweep_f64):
            fn.argtypes = [p] * 11 + [i, i, i, ll, ll, i, ll, ll, ll, i, i,
                                      p, p, p, p]
            fn.restype = i
        lib.raocp_sweep_smem.argtypes = [i] * 8
        lib.raocp_sweep_smem.restype = ll
        lib.raocp_error_string.argtypes = [i]
        lib.raocp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# What the wrapper keeps per problem (per StackedProblem object, dropped
# with it): that its tables were checked and, once it has run on a card,
# what a call hands the library besides the arrays of the apply: the
# schedule and the kernel's copy of the stage weights. The launch that runs
# a stage makes each product's output columns in passes of cw columns; the
# product's right operand [Kp, N] is stored as [passes, Kp, cw], chunk after
# chunk, with zero rows where the left operand has padding columns and zero
# columns past N, so that a slab of rows of one chunk is one contiguous,
# 16-byte-aligned run that a single bulk copy moves (transposes, padding and
# reordering only).
_PROBLEMS = {}


def _problem(sp):
    """The wrapper's record of ``sp``; raises on a problem the kernel does
    not take."""
    record = _PROBLEMS.get(id(sp))
    if record is None:
        if not _fits(sp):
            raise ValueError("the sweep kernel needs a stage-constant tree "
                             "(sweep_eligible); use prox.project_dynamics")
        if sp.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the sweep kernel takes float32/float64, "
                            f"not {sp.dtype}")
        for name in ("ab_bwd", "ab_fwd", "k_s", "rinv_s", "sumapb_s"):
            if not all(t.is_contiguous() for t in getattr(sp, name)):
                raise ValueError(
                    f"the stage weights {name} must be contiguous")
        record = _PROBLEMS[id(sp)] = dict(
            shapes=((sp.np_pad, sp.n), (sp.nl_pad, sp.m), (sp.n,)),
            calls={})
        weakref.finalize(sp, _PROBLEMS.pop, id(sp), None)
    return record


def _check(sp, x_in, u_in, x0):
    """Raise on what the kernel does not take; return the wrapper's record
    of ``sp``, the lane count (1 without a lane axis) and x0 as [lanes,
    n]. The iterates are x [np_pad, n], u [nl_pad, m] and x0 [n] (or [1,
    n]), or x [B, np_pad, n], u [B, nl_pad, m] and x0 [B, n]."""
    record = _problem(sp)
    batched = x_in.dim() == 3
    lanes = x_in.shape[0] if batched else 1
    if not batched and x0.dim() == 2 and x0.shape[0] == 1:
        x0 = x0[0]
    lead = (lanes,) if batched else ()
    for name, t, shape in zip(("x", "u", "x0"), (x_in, u_in, x0),
                              record["shapes"]):
        shape = lead + shape
        if t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != sp.dtype:
            raise TypeError(f"{name} is {t.dtype}, the problem {sp.dtype}")
        if t.device != sp.device:
            raise ValueError(f"{name} is on {t.device}, the problem on "
                             f"{sp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lanes < 1:
        raise ValueError("a batch of the sweep needs at least one lane")
    return record, lanes, x0.reshape(lanes, sp.n)


def project_dynamics_sweep(sp, x_in, u_in, x0):
    """Fused-sweep dynamics projection; same contract as
    :func:`raocp_tpu_torch.ops.prox.project_dynamics` for eligible
    problems. Returns (x [np_pad, n], u [nl_pad, m]), or with a lane axis
    (x [B, np_pad, n], u [B, nl_pad, m]): all B lanes in one launch set."""
    record, lanes, x0 = _check(sp, x_in, u_in, x0)
    device = x_in.device
    if device.type == "cpu":
        return project_dynamics_sweep_ref(sp, x_in, u_in, x0)
    if device.type != "cuda":
        raise ValueError(f"the sweep kernel runs on CUDA tensors, not on "
                         f"{device}")
    global LAUNCHES, RECORDED
    call = record["calls"].get(lanes)
    if call is None:
        call = record["calls"][lanes] = _kernel_call(sp, lanes)
    x_out = torch.empty_like(x_in)
    u_out = torch.empty_like(u_in)
    # q and d of the backward sweep, one allocation: d starts 256-byte
    # aligned behind q; each has the lane stride of x or u
    scratch = torch.empty(call["scratch_bytes"], dtype=torch.uint8,
                          device=device)
    q_buf = scratch.data_ptr()
    with contextlib.nullcontext() if torch.cuda.current_device() \
            == device.index else torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = call["fn"](x_in.data_ptr(), u_in.data_ptr(), x0.data_ptr(),
                         x_out.data_ptr(), u_out.data_ptr(), q_buf,
                         q_buf + call["d_offset"], *call["static_args"],
                         stream)
    if err == -2:
        raise RuntimeError("the sweep kernel's library does not take the "
                           "schedule or a product's layout: "
                           f"{call['plan']['launches']}")
    if err != 0:
        lib = _library()
        raise DeviceFault(f"the sweep kernel failed to launch: CUDA error "
                          f"{err} ({lib.raocp_error_string(err).decode()})")
    if torch.cuda.is_current_stream_capturing():
        RECORDED += 1
    else:
        LAUNCHES += 1
    return x_out, u_out


def _packed(blocks, width, product):
    """The right operand of one product: ``blocks`` (matrices of ``width``
    columns) stacked, each padded with zero rows to a multiple of 4 rows,
    then cut into the passes' column chunks: [passes, Kp, cw]."""
    kp, passes, cpp, _ = product
    cw = 4 * cpp
    pad = torch.nn.functional.pad
    mat = torch.cat([pad(b, (0, 0, 0, -b.shape[0] % 4)) for b in blocks])
    assert mat.shape == (kp, width)
    mat = pad(mat, (0, passes * cw - width))
    return mat.reshape(kp, passes, cw).permute(1, 0, 2).contiguous()


def _kernel_call(sp, lanes=1):
    """What a call on ``sp`` with ``lanes`` lanes hands the library: the
    entry point, the schedule's arrays, each product's layout and its
    packed weights (kept alive here)."""
    lib = _library()
    plan = sweep_schedule(sp, lanes)
    n, m = sp.n, sp.m
    ns_nl = sp.num_stages - 1
    esize = _esize(sp.dtype)
    shape = {}                      # (stage, forward) -> (tile, tm)
    for la in plan["launches"]:
        for k in la["stages"]:
            for fwd in ((False, True) if la["kind"] == "apex"
                        else (la["direction"] == "forward",)):
                shape[k, fwd] = (la["tile"], la["tm"])
    tensors, layouts = [], []
    for k, c in enumerate(sp.stage_child):
        ab_fwd = sp.ab_fwd[k].reshape(n + m, c * n)
        blocks = ([sp.ab_bwd[k].reshape(c * n, n + m)], [sp.rinv_s[k].T],
                  [sp.k_s[k], sp.sumapb_s[k].T], [sp.k_s[k].T],
                  [ab_fwd[:n], ab_fwd[n:]])
        products = [_product(*shape[k, fwd], width, kp)
                    for fwd in (False, True)
                    for width, kp in _products(fwd, n, m, c)]
        tensors += [_packed(bl, bl[0].shape[1], pr)
                    for bl, pr in zip(blocks, products)]
        layouts += [v for pr in products for v in pr]
    held = (
        (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors]),
        (ctypes.c_int * len(layouts))(*layouts),
        (ctypes.c_longlong * len(sp.stage_start))(*sp.stage_start),
        (ctypes.c_longlong * ns_nl)(*sp.stage_child),
        *plan["c_arrays"])
    addr = [ctypes.addressof(a) for a in held]
    # the lanes of x, u and x0 (contiguous: _check) and of q and d
    sx, su = sp.np_pad * n, sp.nl_pad * m
    d_offset = _round_up(lanes * sx * esize, 256)
    return dict(
        fn=lib.raocp_sweep_f32 if esize == 4 else lib.raocp_sweep_f64,
        plan=plan, tensors=tensors, held=held, d_offset=d_offset,
        scratch_bytes=d_offset + lanes * su * esize,
        static_args=(*addr[:4], sp.num_stages, n, m, sp.np_pad, sp.nl_pad,
                     lanes, sx, su, n, plan["apex_stages"],
                     plan["apex_tile"], *addr[4:]))


# ---------------------------------------------------------------- schedule
# How the work of one apply is dealt to launches, blocks and threads is
# decided here and nowhere else: the library is handed each launch's thread
# tile, row tile and grid and each product's layout, and checks them. Only
# the layout of a tile's row arrays in shared memory (``_row_elems``) is
# the kernel's own and mirrored here, so that a plan can be made, and
# tested, without a card; ``raocp_sweep_smem`` holds the two together.

THREADS = 256            # multiplying threads of a block
SLAB_ROW_BYTES = 128     # a slab holds 128 / esize rows of K
RING = 4                 # slabs in flight
MAX_CPP = 48             # most column groups of 4 of a pass: 24 KB a slab
MAX_SPLIT = 8            # most threads that share an output (split K)
MIN_SPLIT_K = 64         # least rows of K that are split
MAX_APEX = 16            # most stages of one apex launch
HEADER_BYTES = 128       # the slabs' barriers, ahead of the slabs
MAX_SMEM = 232448        # bytes of shared memory a block may use (227 KB)
NUM_SMS = 132            # blocks of one wave where no card says otherwise
APEX_TM = 1              # rows of a thread's tile in the apex launch
MAX_TILE = 128           # most rows of a tile
# The rules below were measured per launch on an NVIDIA H100 (PERF.md).
# A stage joins the apex while it has at most APEX_ROWS rows, which a launch
# of its own could not spread over the card, or so little work (APEX_FLOP)
# that a launch costs more than its share of a single block's time.
APEX_ROWS = 4
APEX_FLOP = 50_000
# In a batch the apex runs a block a lane, each block its lane's top stages
# under the rule above (PERF.md: measured against all lanes in one block).
# Below the apex a stage's rows are dealt evenly to one block an SM. The
# thread tile is tm rows by 4 columns: (least rows a block, tm), the widest
# that fits first; float64 has no kernel of 8 rows (registers).
THREAD_TILES = {4: ((32, 8), (12, 4), (4, 2), (1, 1)),
                8: ((12, 4), (4, 2), (1, 1))}


def _round_up(v, q):
    return -(-v // q) * q


def _lead_dim(k):
    r = _round_up(k, 4)
    return r + 4 if r % 8 == 0 else r


def _products(forward, n, m, c):
    """(output columns, padded rows of K) of each product of a stage
    step."""
    n4, m4 = _round_up(n, 4), _round_up(m, 4)
    if forward:
        return ((m, n4), (c * n, n4 + m4))
    return ((n + m, _round_up(c * n, 4)), (m, m4), (n, 2 * m4))


def _product(tile, tm, width, kp):
    """How the product [tile, kp] x [kp, width] is dealt to a block's
    threads, as the library takes it: (kp, passes, cpp, ks). The tile's
    tile // tm row groups each meet the ``width`` / 4 column groups in
    ``passes`` passes of ``cpp`` groups, so that a pass has a thread for
    every pair. Where a thread owns one row, threads are left over and the
    sums are long enough, a power of two ``ks`` of them share an output and
    split the rows of K."""
    nrg = tile // tm
    ncg = -(-width // 4)
    passes = -(-ncg // min(THREADS // nrg, MAX_CPP))
    cpp = -(-ncg // passes)
    ks = 1
    if tm == 1 and kp >= MIN_SPLIT_K:
        while 2 * ks <= MAX_SPLIT and 2 * ks * nrg * cpp <= THREADS:
            ks *= 2
    return kp, passes, cpp, ks


def _row_elems(forward, n, m, c):
    """Shared-memory elements of the row arrays of one row of a tile."""
    n4, m4 = _round_up(n, 4), _round_up(m, 4)
    if forward:
        return _lead_dim(n4 + m4)
    return _lead_dim(c * n) + _lead_dim(n) + _lead_dim(m) + _lead_dim(2 * m4)


def slab_cols(forward, tile, tm, n, m, c):
    """Columns of a slab: those of the widest pass of any product."""
    return 4 * max(_product(tile, tm, w, kp)[2]
                   for w, kp in _products(forward, n, m, c))


def smem_bytes(forward, tile, tm, n, m, c, esize):
    """Dynamic shared memory of a block that runs ``tile``-row tiles with
    thread tile ``tm`` in one direction of a stage; equal to the library's
    ``raocp_sweep_smem``."""
    slabs = RING * (SLAB_ROW_BYTES // esize) \
        * slab_cols(forward, tile, tm, n, m, c)
    partial = 2 * THREADS * 4 if tm == 1 else 0     # a split product's sums
    return HEADER_BYTES \
        + (slabs + tile * _row_elems(forward, n, m, c) + partial) * esize


def _flop_per_row(n, m, c):
    """Operations of both steps of a stage on one of its rows: backward
    2 c n (n+m) + 2 m^2 + 4 m n, forward 2 n m + 2 (n+m) c n."""
    return (2 * c * n * (n + m) + 2 * m * m + 4 * m * n
            + 2 * n * m + 2 * (n + m) * c * n)


def _largest_tile(tm, n, m, children, esize, directions, most=MAX_TILE):
    """The most rows (a multiple of ``tm``, at most ``most`` rounded up to
    one) of a tile that fits in shared memory for every child count and
    direction given; 0 where not even ``tm`` rows fit."""
    tile = _round_up(most, tm)
    while tile and any(smem_bytes(fwd, tile, tm, n, m, c, esize) > MAX_SMEM
                       for c in children for fwd in directions):
        tile -= tm
    return tile


@functools.lru_cache(maxsize=64)
def plan_sweep(stage_rows, stage_child, n, m, esize, sms=NUM_SMS, lanes=1):
    """The launches of one apply of ``lanes`` lanes on a tree whose nonleaf
    stage k has ``stage_rows[k]`` rows of ``stage_child[k]`` children each,
    on a card of ``sms`` SMs.

    The apex runs a block a lane and takes the stages from the root down
    while a lane's rows of them are few (``APEX_ROWS``, ``APEX_FLOP``).
    Every stage below it runs one launch in each direction over the
    ``lanes * stage_rows[k]`` rows of all lanes: they are dealt evenly to
    ``sms`` blocks, in as many rounds as the largest tile that fits in
    shared memory makes necessary (the blocks then walk over the tiles),
    and the thread tile follows the rows of a block (``THREAD_TILES``).
    One lane is the unbatched apply.

    Returns a dict: ``apex_stages`` (stages 0 .. apex_stages-1 run in the
    apex launch), ``apex_tile``, ``lanes``, ``launches``
    (the launches in order, each a dict with ``kind`` "apex" or "stage",
    ``direction``, ``stages``, ``tm``, ``tile``, ``grid``, ``smem`` and
    ``zero_ghosts``), ``launch_count``, and ``c_arrays`` (the per-stage
    thread tile, row tile and grid as the library takes them)."""
    ns_nl = len(stage_rows)
    if lanes < 1:
        raise ValueError(f"a sweep needs at least one lane, not {lanes}")
    # The kernel indexes a launch's rows (all lanes of a stage) with 32-bit
    # unsigned integers and computes element offsets in 64 bits
    # (``RowMap::at``), so only the rows of a stage are bounded here. At
    # 797,161 nodes and n = 50 (one lane) the largest element offset is
    # 39.9 M, far from either limit.
    if lanes * max(stage_rows) >= 2 ** 31:
        raise ValueError(f"{lanes} lanes of {max(stage_rows)} rows pass "
                         "the kernel's 32-bit row index")

    def too_wide(c):
        return RuntimeError(
            f"one row of the sweep kernel (n={n}, m={m}, c={c}, "
            f"{esize}-byte elements) does not fit in the {MAX_SMEM} bytes "
            "of shared memory a block may use")

    apex = 1
    while apex < min(ns_nl, MAX_APEX) and (
            stage_rows[apex] <= APEX_ROWS or stage_rows[apex]
            * _flop_per_row(n, m, stage_child[apex]) <= APEX_FLOP):
        apex += 1
    apex_child = set(stage_child[:apex])
    apex_tile = _largest_tile(APEX_TM, n, m, apex_child, esize, (False, True),
                              min(MAX_TILE, max(stage_rows[:apex])))
    if not apex_tile:
        raise too_wide(max(apex_child))
    apex_smem = max(smem_bytes(fwd, apex_tile, APEX_TM, n, m, c, esize)
                    for c in apex_child for fwd in (False, True))

    def stage_launch(k, forward):
        rows, c = lanes * stage_rows[k], stage_child[k]
        share = -(-rows // sms)             # rows of a block, in one round
        # the widest thread tile the share allows of which a tile fits
        for least, tm in THREAD_TILES[esize]:
            most = share >= least and _largest_tile(tm, n, m, (c,), esize,
                                                    (forward,))
            if most:
                break
        else:
            raise too_wide(c)
        rounds = -(-share // most)
        tile = _round_up(-(-rows // (sms * rounds)), tm)
        tiles = -(-rows // tile)
        return dict(kind="stage",
                    direction="forward" if forward else "backward",
                    stages=(k,), rows=rows, tm=tm, tile=tile, tiles=tiles,
                    grid=min(tiles, sms),
                    smem=smem_bytes(forward, tile, tm, n, m, c, esize),
                    zero_ghosts=forward and k == ns_nl - 1)

    launches = [stage_launch(k, False) for k in range(ns_nl - 1, apex - 1, -1)]
    launches.append(dict(kind="apex", direction="both",
                         stages=tuple(range(apex)),
                         rows=lanes * sum(stage_rows[:apex]), tm=APEX_TM,
                         tile=apex_tile, tiles=None,
                         grid=lanes, smem=apex_smem,
                         zero_ghosts=apex == ns_nl))
    launches += [stage_launch(k, True) for k in range(apex, ns_nl)]

    arrays = [[0] * (2 * ns_nl) for _ in range(3)]
    for launch in launches:
        if launch["kind"] == "stage":
            e = launch["stages"][0] \
                + (ns_nl if launch["direction"] == "forward" else 0)
            for arr, key in zip(arrays, ("tm", "tile", "grid")):
                arr[e] = launch[key]
    c_arrays = tuple((ctypes.c_int * (2 * ns_nl))(*arr) for arr in arrays)
    return dict(apex_stages=apex, apex_tile=apex_tile, lanes=lanes,
                launches=launches, launch_count=len(launches),
                c_arrays=c_arrays)


def _esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def sweep_schedule(sp, lanes=1):
    """The launches of one apply of ``lanes`` lanes on ``sp``
    (:func:`plan_sweep`), for the card the problem lies on, or for
    ``NUM_SMS`` SMs where it lies on none."""
    ss = sp.stage_start
    rows = tuple(ss[k + 1] - ss[k] for k in range(sp.num_stages - 1))
    sms = NUM_SMS if sp.device.type != "cuda" else \
        torch.cuda.get_device_properties(sp.device).multi_processor_count
    return plan_sweep(rows, tuple(sp.stage_child), sp.n, sp.m,
                      _esize(sp.dtype), sms, lanes)


def sweep_work(sp, lanes=1):
    """The operations and the compulsory bytes of one apply of ``lanes``
    lanes, from the shapes: ``flop`` (:func:`_flop_per_row` per nonleaf
    node and lane) and ``bytes`` (each lane's x, u and x0 read once and
    its padded x and u written once; each stage's weights read once for
    all lanes)."""
    n, m, ss = sp.n, sp.m, sp.stage_start
    flop = weights = 0
    for k, c in enumerate(sp.stage_child):
        rows = ss[k + 1] - ss[k]
        flop += rows * _flop_per_row(n, m, c)
        weights += 2 * c * n * (n + m) + 2 * m * n + m * m
    lane = (sp.num_nodes * n + sp.num_nonleaf * m + n
            + sp.np_pad * n + sp.nl_pad * m)
    return dict(flop=lanes * flop,
                bytes=(lanes * lane + weights) * _esize(sp.dtype))


def project_dynamics_sweep_ref(sp, x_in, u_in, x0):
    """The plain torch version of the kernel's math, step for step: the
    backward launches (abtq, d, q per stage) and the forward launches (u and
    the children's x per stage), then the zeroed ghost rows. Takes the
    iterates with or without a leading lane axis (x0 [..., n])."""
    ss = sp.stage_start
    ns = sp.num_stages
    n, m = sp.n, sp.m
    N = sp.num_nodes
    lead = tuple(x_in.shape[:-2])
    x_out = x_in.new_zeros(x_in.shape)
    u_out = u_in.new_zeros(u_in.shape)
    q = x_in.new_zeros(x_in.shape)
    d = u_in.new_zeros(u_in.shape)
    # backward: the last nonleaf stage reads q_leaf = -x_leaf
    q[..., ss[ns - 1]:N, :] = -x_in[..., ss[ns - 1]:N, :]
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        c = sp.stage_child[k]
        qc = q[..., a2:b2, :].reshape(lead + (b - a, c * n))
        abtq = qc @ sp.ab_bwd[k].reshape(c * n, n + m)    # [W, n+m]
        sum_atq, sum_btq = abtq[..., :n], abtq[..., n:]
        u_k = u_in[..., a:b, :]
        d_k = (u_k - sum_btq) @ sp.rinv_s[k].T
        g = (d_k - u_k) + sum_btq
        q[..., a:b, :] = ((-x_in[..., a:b, :] + g @ sp.k_s[k])
                          + d_k @ sp.sumapb_s[k].T) + sum_atq
        d[..., a:b, :] = d_k
    # forward: parents' x from x0 at the root, else from the stage above
    x_out[..., 0:1, :] = x0.reshape(lead + (1, n))
    for k in range(ns - 1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        c = sp.stage_child[k]
        x_k = x_out[..., a:b, :]
        u_k = x_k @ sp.k_s[k].T + d[..., a:b, :]
        u_out[..., a:b, :] = u_k
        xu = torch.cat([x_k, u_k], dim=-1)               # [W, n+m]
        x_out[..., a2:b2, :] = (xu @ sp.ab_fwd[k].reshape(n + m, c * n)) \
            .reshape(lead + (b2 - a2, n))
    # ghost rows past N and NL stay zero (new_zeros above)
    return x_out, u_out
