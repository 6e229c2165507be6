"""K1: the dynamics-projection DP sweeps as a hand-written CUDA kernel.

Counterpart of :mod:`raocp_tpu.ops.pallas_sweep` (the Pallas TPU kernel
``_sweep_kernel``). The projection of (x, u) onto the dynamics subspace
(reference ``cache.py:259-288``) is a backward stage recursion followed by
a forward rollout. On trees whose every nonleaf stage is stage-constant
(:func:`sweep_eligible`), :func:`project_dynamics_sweep` runs it as one
fused launch per stage and direction (``csrc/sweep.cu``, built with
``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``).

* CUDA tensors: the kernel runs, or the call raises. There is no fallback.
* CPU tensors: :func:`project_dynamics_sweep_ref`, the plain torch version
  of exactly the kernel's math, runs instead.

``LAUNCHES`` counts the calls that launched the kernel, so a run can show
that its main path went through it.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["sweep_eligible", "project_dynamics_sweep",
           "project_dynamics_sweep_ref", "build_library", "LAUNCHES"]

LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sweep.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raocp_tpu_torch"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_LIB = None


def sweep_eligible(sp) -> bool:
    """The structural gate: every nonleaf stage has a stage-stacked
    [A | B] block and stage-constant Riccati tables."""
    return (all(w is not None for w in sp.ab_bwd)
            and all(k is not None for k in sp.k_s))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("building the sweep kernel needs the CUDA "
                           "toolkit (nvcc); none was found")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library() -> Path:
    """Compile ``csrc/sweep.cu`` into ``build/raocp_tpu_torch/`` (keyed by a
    hash of the source and flags) unless that library exists; return its
    path. A failed build raises with nvcc's output."""
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"sweep_{key[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SOURCE.name}:\n"
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
            fn.argtypes = [p] * 14 + [i, i, i, ll, ll, p]
            fn.restype = i
        lib.raocp_error_string.argtypes = [i]
        lib.raocp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(sp, x_in, u_in, x0):
    """Raise on what the kernel does not take; return x0 as [1, n]."""
    if not sweep_eligible(sp):
        raise ValueError("the sweep kernel needs a stage-constant tree "
                         "(sweep_eligible); use prox.project_dynamics")
    if sp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the sweep kernel takes float32/float64, "
                        f"not {sp.dtype}")
    for name in ("ab_bwd", "ab_fwd", "k_s", "rinv_s", "sumapb_s"):
        if not all(t.is_contiguous() for t in getattr(sp, name)):
            raise ValueError(f"the stage weights {name} must be contiguous")
    x0 = x0.reshape(1, sp.n)
    for name, t, shape in (("x", x_in, (sp.np_pad, sp.n)),
                           ("u", u_in, (sp.nl_pad, sp.m)),
                           ("x0", x0, (1, sp.n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != sp.dtype:
            raise TypeError(f"{name} is {t.dtype}, the problem {sp.dtype}")
        if t.device != sp.device:
            raise ValueError(f"{name} is on {t.device}, the problem on "
                             f"{sp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return x0


def project_dynamics_sweep(sp, x_in, u_in, x0):
    """Fused-sweep dynamics projection; same contract as
    :func:`raocp_tpu_torch.ops.prox.project_dynamics` for eligible
    problems. Returns (x [np_pad, n], u [nl_pad, m])."""
    x0 = _check(sp, x_in, u_in, x0)
    if x_in.device.type == "cpu":
        return project_dynamics_sweep_ref(sp, x_in, u_in, x0)
    if x_in.device.type != "cuda":
        raise ValueError(f"the sweep kernel runs on CUDA tensors, not on "
                         f"{x_in.device}")
    global LAUNCHES
    lib = _library()
    fn = lib.raocp_sweep_f32 if sp.dtype == torch.float32 \
        else lib.raocp_sweep_f64
    ns_nl = sp.num_stages - 1
    x_out = torch.empty_like(x_in)
    u_out = torch.empty_like(u_in)
    q_buf = torch.empty_like(x_in)
    d_buf = torch.empty_like(u_in)

    def ptrs(tabs):
        return (ctypes.c_void_p * ns_nl)(*[t.data_ptr() for t in tabs])

    stage_start = (ctypes.c_longlong * len(sp.stage_start))(*sp.stage_start)
    stage_child = (ctypes.c_longlong * ns_nl)(*sp.stage_child)
    with torch.cuda.device(x_in.device):
        stream = torch.cuda.current_stream(x_in.device).cuda_stream
        err = fn(x_in.data_ptr(), u_in.data_ptr(), x0.data_ptr(),
                 x_out.data_ptr(), u_out.data_ptr(), q_buf.data_ptr(),
                 d_buf.data_ptr(), ptrs(sp.ab_bwd), ptrs(sp.ab_fwd),
                 ptrs(sp.k_s), ptrs(sp.rinv_s), ptrs(sp.sumapb_s),
                 ctypes.addressof(stage_start), ctypes.addressof(stage_child),
                 sp.num_stages, sp.n, sp.m, sp.np_pad, sp.nl_pad, stream)
    if err == -2:
        raise RuntimeError(
            f"the sweep kernel's stage weights (n={sp.n}, m={sp.m}, "
            f"c={max(sp.stage_child)}, {sp.dtype}) do not fit in the "
            "227 KB of shared memory a block may use")
    if err != 0:
        raise RuntimeError(f"the sweep kernel failed to launch: CUDA error "
                           f"{err} ({lib.raocp_error_string(err).decode()})")
    LAUNCHES += 1
    return x_out, u_out


def project_dynamics_sweep_ref(sp, x_in, u_in, x0):
    """The plain torch version of the kernel's math, step for step: the
    backward launches (abtq, d, q per stage) and the forward launches (u and
    the children's x per stage), then the zeroed ghost rows."""
    ss = sp.stage_start
    ns = sp.num_stages
    n, m = sp.n, sp.m
    N = sp.num_nodes
    x0 = x0.reshape(1, n)
    x_out = x_in.new_zeros(x_in.shape)
    u_out = u_in.new_zeros(u_in.shape)
    q = x_in.new_zeros(x_in.shape)
    d = u_in.new_zeros(u_in.shape)
    # backward: the last nonleaf stage reads q_leaf = -x_leaf
    q[ss[ns - 1]:N] = -x_in[ss[ns - 1]:N]
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        c = sp.stage_child[k]
        qc = q[a2:b2].reshape(b - a, c * n)
        abtq = qc @ sp.ab_bwd[k].reshape(c * n, n + m)    # [W, n+m]
        sum_atq, sum_btq = abtq[:, :n], abtq[:, n:]
        u_k = u_in[a:b]
        d_k = (u_k - sum_btq) @ sp.rinv_s[k].T
        g = (d_k - u_k) + sum_btq
        q[a:b] = ((-x_in[a:b] + g @ sp.k_s[k]) + d_k @ sp.sumapb_s[k].T) \
            + sum_atq
        d[a:b] = d_k
    # forward: parents' x from x0 at the root, else from the stage above
    x_out[0:1] = x0
    for k in range(ns - 1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        c = sp.stage_child[k]
        x_k = x_out[a:b]
        u_k = x_k @ sp.k_s[k].T + d[a:b]
        u_out[a:b] = u_k
        xu = torch.cat([x_k, u_k], dim=1)                # [W, n+m]
        x_out[a2:b2] = (xu @ sp.ab_fwd[k].reshape(n + m, c * n)) \
            .reshape(b2 - a2, n)
    # ghost rows past N and NL stay zero (new_zeros above)
    return x_out, u_out
