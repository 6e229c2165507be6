"""The dual half of a Chambolle-Pock step as one hand-written CUDA kernel.

From (eta, L z, L z+, alpha2, the epigraph half-shift) the step's dual
update is the Moreau form of prox_{alpha2 g*} (reference
``cache.py:321-393``)::

    mod  = (eta + alpha2 (2 L z+ - L z)) / alpha2 + shift
    eta+ = alpha2 (mod - proj(mod))

with ``proj`` the cone, box and ball projections of
:func:`raocp_tpu_torch.ops.prox.g_conj_projections`. Every row of every dual
part depends only on the same row of eta, L z, L z+ and the problem's
tables, so :func:`dual_update` runs the whole map as one launch of
``csrc/dual.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, a library
of its own, and bound with ``ctypes``); ``mod`` and ``proj`` never reach
device memory. It replaces no TPU kernel: the JAX package leaves the map to
XLA, which fuses it; in PyTorch it was 169 launches a step at BASELINE
config 4.

* CUDA tensors: the kernel runs, or the call raises. There is no fallback.
* CPU tensors: :func:`dual_update_plain`, the step's three statements as
  they were, runs instead: the CPU path and the kernel's oracle.

The kernel takes float32 and float64; a leading lane axis [B, ...] on any
input (a part without it is read by every lane), with alpha2 a number, a
0-d tensor or one per lane [B], read on the device (the call is captured
in the loops' CUDA graphs, where the step sizes change under
``adaptive``); parts that are strided or aliased views (``ell``'s e3 and e4
are column slices of one tensor, its e5 is its e6), each passed as an
address and its strides, never copied. The half-shift is
:func:`~raocp_tpu_torch.ops.prox.half_shift_dual`'s: zero but on e5, e6,
e12 and e13, which are the parts the kernel reads.

``LAUNCHES`` counts the calls that launched the kernel. A call made while a
CUDA graph is captured launches nothing: it counts in ``RECORDED``, and the
graph's owner adds its launches at each replay (the solver's device loop,
into ``LAUNCHES`` and ``solver.LOOP_COUNTS["dual_launches"]``).
"""

import contextlib
import ctypes
import numbers
from pathlib import Path

import torch

from raocp_tpu_torch.core.variables import Dual, dual_shapes, lane_view
from raocp_tpu_torch.ops import sweep as sweep_mod
from raocp_tpu_torch.ops.prox import g_conj_projections

__all__ = ["dual_update", "dual_update_plain", "build_library",
           "LAUNCHES", "RECORDED"]

LAUNCHES = 0
RECORDED = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dual.cu"
_LIB = None

# the library's layout (csrc/dual.cu): the operands in their order, each
# (address, lane stride, row stride, column stride) in elements, and the
# sizes; a family's threads a block
_PARTS = Dual._fields
_SHIFTS = ("e5", "e6", "e12", "e13")
_TABLES = ("risk_free_rows", "risk_zero_rows", "risk_soc_rows",
           "risk_soc_tail", "nl_lo", "nl_hi", "nl_ball_c", "nl_ball_r",
           "l_lo", "l_hi", "l_ball_c", "l_ball_r")
OPERANDS = 4 * len(_PARTS) + len(_SHIFTS) + len(_TABLES) + 1
DIMS = 19
THREADS = 256
# each row family: its rows, its wide parts (a thread takes their entries
# a few at a time) and the tables those read (e1 and the scalar parts move
# an element at a time)
_FAMILIES = (("nl_pad", ("e7",), ("nl_lo", "nl_hi", "nl_ball_c")),
             ("np_pad", ("e3", "e4"), ()),
             ("lf_pad", ("e11", "e14"), ("l_lo", "l_hi", "l_ball_c")))


def build_library() -> Path:
    """Compile ``csrc/dual.cu`` into ``build/raocp_tpu_torch/`` (as K1's
    library, keyed by a hash of the source and flags) unless it exists."""
    return sweep_mod.build_library(_SOURCE)


def _library():
    """The loaded dual-update library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        p = ctypes.c_void_p
        for fn in (lib.raocp_dual_f32, lib.raocp_dual_f64):
            fn.argtypes = [p, p, ctypes.c_double, p]
            fn.restype = ctypes.c_int
        lib.raocp_dual_layout.argtypes = [ctypes.c_int]
        lib.raocp_dual_layout.restype = ctypes.c_int
        lib.raocp_dual_error_string.argtypes = [ctypes.c_int]
        lib.raocp_dual_error_string.restype = ctypes.c_char_p
        lib.raocp_dual_init.restype = ctypes.c_int
        layout = tuple(lib.raocp_dual_layout(i) for i in range(3))
        if layout != (OPERANDS, DIMS, THREADS):
            raise RuntimeError(f"the dual-update library's layout {layout} "
                               f"is not the wrapper's "
                               f"{(OPERANDS, DIMS, THREADS)}")
        err = lib.raocp_dual_init()
        if err != 0:
            raise RuntimeError(
                f"the dual-update library's start failed: CUDA error {err} "
                f"({lib.raocp_dual_error_string(err).decode()})")
        _LIB = lib
    return _LIB


def dual_update_plain(sp, eta: Dual, Lz: Dual, Lzn: Dual, alpha2,
                      shift: Dual) -> Dual:
    """eta+ = prox_{alpha2 g*}(eta + alpha2 L(2 z+ - z)) via Moreau, in
    plain torch: the CPU path of :func:`dual_update` and its oracle."""
    a2 = [lane_view(alpha2, e) for e in eta]
    mod = Dual(*((e + a * (2.0 * lzn - lz)) / a + s
                 for e, a, lzn, lz, s in zip(eta, a2, Lzn, Lz, shift)))
    proj = g_conj_projections(sp, mod)
    return Dual(*(a * (m - p) for a, m, p in zip(a2, mod, proj)))


def _tables(sp) -> list:
    """The problem's tables as the library reads them (an operand each, in
    ``_TABLES`` order), checked against its dual's shapes; raises on a
    table the kernel does not take."""
    shapes = dict(risk_free_rows=(sp.nl_pad, sp.Y),
                  risk_zero_rows=(sp.nl_pad, sp.Y),
                  risk_soc_rows=(sp.nl_pad, sp.Y),
                  risk_soc_tail=(sp.nl_pad, sp.Y),
                  nl_lo=(sp.nl_pad, sp.nl_rows), nl_hi=(sp.nl_pad, sp.nl_rows),
                  nl_ball_c=(sp.nl_pad, sp.nl_rows), nl_ball_r=(sp.nl_pad,),
                  l_lo=(sp.lf_pad, sp.l_rows), l_hi=(sp.lf_pad, sp.l_rows),
                  l_ball_c=(sp.lf_pad, sp.l_rows), l_ball_r=(sp.lf_pad,))
    ops = []
    for name in _TABLES:
        t = getattr(sp, name)
        if t is None:
            if name in ("risk_soc_rows", "risk_soc_tail"):
                ops.append((0, 0, 0, 0))
                continue
            raise ValueError(f"the problem has no table {name}")
        want = torch.bool if name.startswith("risk_") else sp.dtype
        if tuple(t.shape) != shapes[name] or t.dtype != want:
            raise ValueError(f"the problem's {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {want} "
                             f"{shapes[name]}")
        st = t.stride()
        ops.append((t.data_ptr(), 0, st[0], st[1] if t.dim() == 2 else 0))
    return ops


def _alpha(alpha2, dtype, device):
    """(lanes of alpha2 or None, the tensor the kernel reads or None, the
    number it reads otherwise), or raises."""
    if isinstance(alpha2, torch.Tensor):
        if alpha2.dim() > 1:
            raise ValueError(f"alpha2 has shape {tuple(alpha2.shape)}: a "
                             f"number, a 0-d tensor or one per lane [B]")
        if alpha2.dtype != dtype:
            raise TypeError(f"alpha2 is {alpha2.dtype}, the dual {dtype}")
        if alpha2.device != device:
            raise ValueError(f"alpha2 is on {alpha2.device}, the dual on "
                             f"{device}")
        lanes = alpha2.shape[0] if alpha2.dim() == 1 else None
        return lanes, alpha2, 0.0
    if not isinstance(alpha2, numbers.Real):
        raise TypeError(f"alpha2 is a {type(alpha2).__name__}: a number or "
                        f"a tensor")
    return None, None, float(alpha2)


def _layout(sp, eta, Lz, Lzn, alpha2, shift):
    """Check a call and lay it out for the library; raises on what the
    kernel does not take. Returns (the output's leading lane shape, the
    operands in the library's order but the outputs', the sizes but the
    vector widths and group sizes, alpha2 as a number where no tensor
    holds it)."""
    dtype, device = sp.dtype, sp.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the dual-update kernel takes float32/float64, "
                        f"not {dtype}")
    dual = dual_shapes(sp)
    shapes = [torch.Size(shape) for shape in dual]
    inputs, lanes = [], set()
    for tree, what in ((eta, "eta"), (Lz, "L z"), (Lzn, "L z+")):
        if len(tree) != len(_PARTS):
            raise ValueError(f"{what} has {len(tree)} parts, not "
                             f"{len(_PARTS)}")
        for name, t, shape in zip(_PARTS, tree, shapes):
            if t.dtype != dtype:
                raise TypeError(f"{what}'s {name} is {t.dtype}, the "
                                f"problem {dtype}")
            if t.device != device:
                raise ValueError(f"{what}'s {name} is on {t.device}, the "
                                 f"problem on {device}")
            extra = t.dim() - len(shape)
            if extra not in (0, 1) or t.shape[extra:] != shape:
                raise ValueError(f"{what}'s {name} has shape "
                                 f"{tuple(t.shape)}, expected [B,] "
                                 f"{tuple(shape)}")
            if extra:
                lanes.add(t.shape[0])
            inputs.append((t, extra, len(shape) == 2))
    for name in _SHIFTS:
        t, shape = getattr(shift, name), getattr(dual, name)
        if t.dtype != dtype or t.device != device or t.shape != shape:
            raise ValueError(f"the half-shift's {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{dtype} {shape} on {device}")
        inputs.append((t, 0, False))
    a_lanes, a_tensor, a_value = _alpha(alpha2, dtype, device)
    if a_lanes is not None:
        lanes.add(a_lanes)
    count = max(lanes, default=1)
    if lanes - {1, count}:
        raise ValueError(f"the dual's lane axes do not agree: "
                         f"{sorted(lanes)}")
    if a_lanes not in (None, count):
        raise ValueError(f"alpha2 has {a_lanes} lanes, the dual {count}")
    lead = (count,) if lanes else ()
    ops = []
    for t, extra, cols in inputs:
        st = t.stride()
        ops.append((t.data_ptr(),
                    st[0] if extra and t.shape[0] != 1 else 0, st[extra],
                    st[extra + 1] if cols else 0))
    ops += _tables(sp)
    ops.append((0, 0, 0, 0) if a_tensor is None
               else (a_tensor.data_ptr(),
                     a_tensor.stride(0) if a_tensor.dim() else 0, 0, 0))
    dims = [count, sp.nl_pad, sp.np_pad, sp.lf_pad, sp.Y, sp.nl_rows, sp.n,
            sp.m, sp.l_rows, int(sp.risk_soc_rows is not None)]
    return lead, ops, dims, a_value


def _vector(widths, esize):
    """The entries a thread takes together in a family's wide parts: the
    widest vector (16 bytes, else 2 elements) that divides every width."""
    for v in (16 // esize, 2):
        if all(w % v == 0 for w, _ in widths):
            return v
    return 1


def _aligned(widths, v, esize):
    """Whether every operand of a family's wide parts takes ``v``-element
    vector loads: unit column strides, and addresses, row and lane strides
    that are multiples of the vector's bytes."""
    return all(p == 0 or (cs == 1 and p % (v * esize) == 0 and rs % v == 0
                          and ls % v == 0)
               for _, group in widths for p, ls, rs, cs in group)


def _plan(sp, ops) -> tuple:
    """Each row family's entries a thread takes together (:func:`_vector`:
    from the widths and the element size alone, so that the order of a
    row's sums, and so eta+'s bits, never depend on the operands'
    layout), its group size (the least power of two from 4 to 32 threads
    that leaves a thread at most two of those in the family's widest part)
    and whether its operands take them as vector loads
    (:func:`_aligned`), from the call's operands (the library's order, the
    outputs' included): (vectors, groups, aligned)."""
    esize = 8 if sp.dtype == torch.float64 else 4
    n = len(_PARTS)
    part = {name: i for i, name in enumerate(_PARTS)}
    table = {name: 4 * n + len(_SHIFTS) + i for i, name in enumerate(_TABLES)}
    cols = dict(e7=sp.nl_rows, e3=sp.n, e4=sp.m, e11=sp.n, e14=sp.l_rows)
    vecs, groups, aligned = [], [], []
    for rows, wide, tables in _FAMILIES:
        widths = []
        for name in wide:
            group = [ops[k * n + part[name]] for k in range(4)]
            if name in ("e7", "e14"):
                group += [ops[table[t]] for t in tables]
            widths.append((cols[name], group))
        v = _vector(widths, esize)
        widest = max([-(-w // v) for w, _ in widths]
                     + ([sp.Y] if rows == "nl_pad" else []))
        g = 4
        while g < 32 and 2 * g < widest:
            g *= 2
        vecs.append(v)
        groups.append(g)
        aligned.append(int(v == 1 or _aligned(widths, v, esize)))
    return tuple(vecs), tuple(groups), tuple(aligned)


def _call(sp, eta, Lz, Lzn, alpha2, shift):
    """The outputs (fresh tensors) and what the library gets: every
    operand, the sizes with each family's plan (:func:`_plan`), and
    alpha2 as a number (where no tensor holds it)."""
    lead, ops, dims, a_value = _layout(sp, eta, Lz, Lzn, alpha2, shift)
    out, outs = [], []
    for shape in dual_shapes(sp):
        t = torch.empty(lead + tuple(shape), dtype=sp.dtype,
                        device=sp.device)
        cols = shape[1] if len(shape) == 2 else 1
        out.append(t)
        outs.append((t.data_ptr(), shape[0] * cols if lead else 0, cols,
                     1 if len(shape) == 2 else 0))
    n = len(_PARTS)
    ops = ops[:3 * n] + outs + ops[3 * n:]
    return Dual(*out), ops, dims + [v for p in _plan(sp, ops) for v in p], \
        a_value


def dual_update(sp, eta: Dual, Lz: Dual, Lzn: Dual, alpha2,
                shift: Dual) -> Dual:
    """The step's dual update, eta+ = alpha2 (mod - proj(mod)) with mod =
    (eta + alpha2 (2 L z+ - L z)) / alpha2 + shift: one launch of the
    kernel for CUDA tensors, :func:`dual_update_plain` for CPU tensors.
    Raises on what the kernel does not take, on either device."""
    device = sp.device
    if device.type == "cpu":
        _layout(sp, eta, Lz, Lzn, alpha2, shift)
        return dual_update_plain(sp, eta, Lz, Lzn, alpha2, shift)
    if device.type != "cuda":
        raise ValueError(f"the dual-update kernel runs on CUDA tensors, "
                         f"not on {device}")
    global LAUNCHES, RECORDED
    out, ops, dims, a_value = _call(sp, eta, Lz, Lzn, alpha2, shift)
    lib = _library()
    fn = lib.raocp_dual_f32 if sp.dtype == torch.float32 \
        else lib.raocp_dual_f64
    flat = (ctypes.c_longlong * (4 * OPERANDS))(*(v for op in ops
                                                  for v in op))
    sizes = (ctypes.c_longlong * DIMS)(*dims)
    with contextlib.nullcontext() if torch.cuda.current_device() \
            == device.index else torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(flat, sizes, a_value, stream)
    if err == -2:
        raise RuntimeError(f"the dual-update library does not take the "
                           f"plan: {dims[-9:]}")
    if err != 0:
        raise sweep_mod.DeviceFault(
            f"the dual-update kernel failed to launch: CUDA error {err} "
            f"({lib.raocp_dual_error_string(err).decode()})")
    if torch.cuda.is_current_stream_capturing():
        RECORDED += 1
    else:
        LAUNCHES += 1
    return out
