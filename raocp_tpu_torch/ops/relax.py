"""The over-relaxation of a Chambolle-Pock step as one hand-written CUDA
kernel.

With ``relax = rho`` the CP loop moves each of its iterates (z, eta, L z,
L'eta) from the current point c toward the step's point p (JAX
``solver.py``'s loop body)::

    out = c + rho (p - c)

leaf by leaf. :func:`over_relax` runs it for every leaf of every pair it is
given as one launch of ``csrc/relax.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, a library of its own, and bound with ``ctypes``),
which reads each c and p once and writes each result once. It replaces no
TPU kernel: the JAX package leaves the relaxation to XLA, which fuses it;
in PyTorch it was three kernels a leaf, 96 launches a step over the loop's
32 leaves, moving 8/3 of the bytes the one pass moves.

* CUDA tensors: the kernel runs, or the call raises. There is no fallback.
* CPU tensors: :func:`over_relax_plain`, the loop's expression as it was,
  runs instead: the CPU path and the kernel's oracle.

The kernel takes float32 and float64, leaves of one to three axes, a
leading lane axis [B, ...] on either side of a pair (a leaf without it is
read by every lane), and inputs that are strided or aliased views (``ell``'s
e3 and e4 are column slices of one tensor, its e5 is its e6), each passed
as an address and its strides, never copied. Each output is a new
contiguous tensor. Its arithmetic is the twin's, each operation rounded
alone in the same order (rho rounded to the leaf's type, as PyTorch rounds
a Python number), so the outputs are the twin's to the bit.

``LAUNCHES`` counts the calls that launched the kernel. A call made while a
CUDA graph is captured launches nothing: it counts in ``RECORDED``, and the
graph's owner adds its launches at each replay (the solver's device loop,
into ``LAUNCHES`` and ``solver.LOOP_COUNTS["relax_launches"]``).
"""

import contextlib
import ctypes
import numbers
from pathlib import Path

import torch

from raocp_tpu_torch.ops import sweep as sweep_mod

__all__ = ["over_relax", "over_relax_plain", "build_library", "LAUNCHES",
           "RECORDED"]

LAUNCHES = 0
RECORDED = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "relax.cu"
_LIB = None

# the library's layout (csrc/relax.cu): leaves a launch, numbers a leaf
# (addresses of c, p and out; c's and p's lane, row and column strides;
# the output's lanes, rows and columns; a slot the library fills; whether
# the leaf moves 16-byte vectors), threads a block, units a thread
LEAVES = 32
FIELDS = 14
THREADS = 256
UNITS = 4


def build_library() -> Path:
    """Compile ``csrc/relax.cu`` into ``build/raocp_tpu_torch/`` (as K1's
    library, keyed by a hash of the source and flags) unless it exists."""
    return sweep_mod.build_library(_SOURCE)


def _library():
    """The loaded relaxation library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        p = ctypes.c_void_p
        for fn in (lib.raocp_relax_f32, lib.raocp_relax_f64):
            fn.argtypes = [p, ctypes.c_int, ctypes.c_double, p]
            fn.restype = ctypes.c_int
        lib.raocp_relax_layout.argtypes = [ctypes.c_int]
        lib.raocp_relax_layout.restype = ctypes.c_int
        lib.raocp_relax_error_string.argtypes = [ctypes.c_int]
        lib.raocp_relax_error_string.restype = ctypes.c_char_p
        lib.raocp_relax_init.restype = ctypes.c_int
        layout = tuple(lib.raocp_relax_layout(i) for i in range(4))
        if layout != (LEAVES, FIELDS, THREADS, UNITS):
            raise RuntimeError(f"the relaxation library's layout {layout} "
                               f"is not the wrapper's "
                               f"{(LEAVES, FIELDS, THREADS, UNITS)}")
        err = lib.raocp_relax_init()
        if err != 0:
            raise RuntimeError(
                f"the relaxation library's start failed: CUDA error {err} "
                f"({lib.raocp_relax_error_string(err).decode()})")
        _LIB = lib
    return _LIB


def _like(tree, leaves):
    """``leaves`` as a tree of ``tree``'s type: a NamedTuple, or a plain
    tuple."""
    leaves = tuple(leaves)
    return type(tree)(*leaves) if hasattr(tree, "_fields") else leaves


def over_relax_plain(rho, pairs) -> tuple:
    """c + rho (p - c) for each leaf of each (current, step) pair of trees,
    in plain torch: the CPU path of :func:`over_relax` and its oracle."""
    return tuple(_like(cur, (c + rho * (p - c) for c, p in zip(cur, new)))
                 for cur, new in pairs)


def _axes(c, p):
    """The output's shape and, outer to inner, each of its axes as (size,
    c's stride, p's stride), a stride 0 where a side broadcasts; raises on
    a pair the kernel does not take."""
    if c.shape == p.shape:
        shape = tuple(c.shape)
    elif c.dim() == p.dim() + 1 and c.shape[1:] == p.shape:
        shape = tuple(c.shape)
    elif p.dim() == c.dim() + 1 and p.shape[1:] == c.shape:
        shape = tuple(p.shape)
    else:
        raise ValueError(f"a pair of shapes {tuple(c.shape)} and "
                         f"{tuple(p.shape)}: equal, or one with a leading "
                         f"lane axis")
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"a leaf of shape {shape}: one to three axes")

    def strides(t):
        st = list(t.stride())
        return [0] * (len(shape) - len(st)) + st

    return shape, list(zip(shape, strides(c), strides(p)))


def _merged(axes):
    """The axes of size 1 dropped and each axis merged into the next where
    both sides step over it as over one longer axis; then padded in front
    to [lanes, rows, cols]."""
    out = []
    for size, cs, ps in axes:
        if size == 1:
            continue
        if out and out[-1][1:] == (size * cs, size * ps):
            out[-1] = (out[-1][0] * size, cs, ps)
        else:
            out.append((size, cs, ps))
    return [(1, 0, 0)] * (3 - len(out)) + out


def _vector(merged, addresses, esize) -> bool:
    """Whether a leaf's units move as 16-byte vectors: unit column strides
    on both sides, 16-byte-aligned addresses, and lane and row strides (the
    output's included) that keep every row's start aligned."""
    v = 16 // esize
    (lanes, cl, pl), (rows, cr, pr), (cols, cc, pc) = merged
    if cols > 1 and (cc != 1 or pc != 1):
        return False
    if any(a % 16 for a in addresses):
        return False
    steps = [(lanes, (cl, pl, rows * cols)), (rows, (cr, pr, cols))]
    return all(size == 1 or all(s % v == 0 for s in st)
               for size, st in steps)


def _leaves(rho, pairs):
    """Check a call; raises on what the kernel does not take. Returns
    (the dtype, the device, each pair's current tree with its leaves as
    (c, p, the output's shape, its axes))."""
    if isinstance(rho, bool) or not isinstance(rho, numbers.Real):
        raise TypeError(f"rho is a {type(rho).__name__}: a number")
    dtype = device = None
    trees = []
    for cur, new in pairs:
        if len(cur) != len(new):
            raise ValueError(f"a pair of trees of {len(cur)} and {len(new)} "
                             f"leaves")
        leaves = []
        for c, p in zip(cur, new):
            for t in (c, p):
                if not isinstance(t, torch.Tensor):
                    raise TypeError(f"a leaf is a {type(t).__name__}, not "
                                    f"a tensor")
                dtype = t.dtype if dtype is None else dtype
                device = t.device if device is None else device
                if t.dtype != dtype:
                    raise TypeError(f"leaves of {dtype} and {t.dtype}")
                if t.device != device:
                    raise ValueError(f"leaves on {device} and {t.device}")
            leaves.append((c, p, *_axes(c, p)))
        trees.append((cur, leaves))
    if dtype is not None and dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the relaxation kernel takes float32/float64, not "
                        f"{dtype}")
    count = sum(len(leaves) for _, leaves in trees)
    if count > LEAVES:
        raise ValueError(f"{count} leaves: the kernel takes at most "
                         f"{LEAVES} a launch")
    return dtype, device, trees


def _table(trees, dtype, device):
    """The outputs (new contiguous tensors, as trees) and the library's
    table of the leaves (:func:`_leaves`)."""
    esize = 8 if dtype == torch.float64 else 4
    outs, table = [], []
    for cur, leaves in trees:
        out = []
        for c, p, shape, axes in leaves:
            o = torch.empty(shape, dtype=dtype, device=device)
            merged = _merged(axes)
            address = (c.data_ptr(), p.data_ptr(), o.data_ptr())
            (lanes, cl, pl), (rows, cr, pr), (cols, cc, pc) = merged
            table += [*address, cl, cr, cc, pl, pr, pc, lanes, rows, cols, 0,
                      int(_vector(merged, address, esize))]
            out.append(o)
        outs.append(_like(cur, out))
    return tuple(outs), table


def over_relax(rho, pairs) -> tuple:
    """c + rho (p - c) for each leaf of each (current, step) pair of trees
    (each pair's trees of one type and as many leaves; the results as
    trees of that type, in their order): one launch of the kernel for
    CUDA tensors, :func:`over_relax_plain` for CPU tensors. Raises on what
    the kernel does not take, on either device."""
    pairs = tuple(pairs)
    dtype, device, trees = _leaves(rho, pairs)
    if device is None or device.type == "cpu":
        return over_relax_plain(rho, pairs)
    if device.type != "cuda":
        raise ValueError(f"the relaxation kernel runs on CUDA tensors, not "
                         f"on {device}")
    global LAUNCHES, RECORDED
    outs, table = _table(trees, dtype, device)
    lib = _library()
    fn = lib.raocp_relax_f32 if dtype == torch.float32 \
        else lib.raocp_relax_f64
    flat = (ctypes.c_longlong * len(table))(*table)
    with contextlib.nullcontext() if torch.cuda.current_device() \
            == device.index else torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(flat, len(table) // FIELDS, float(rho), stream)
    if err == -2:
        raise RuntimeError(f"the relaxation library does not take the "
                           f"table: {table}")
    if err != 0:
        raise sweep_mod.DeviceFault(
            f"the relaxation kernel failed to launch: CUDA error {err} "
            f"({lib.raocp_relax_error_string(err).decode()})")
    if torch.cuda.is_current_stream_capturing():
        RECORDED += 1
    else:
        LAUNCHES += 1
    return outs
