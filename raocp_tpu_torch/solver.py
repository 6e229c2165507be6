"""Chambolle-Pock solver for RAOCPs on torch tensors (counterpart of
:mod:`raocp_tpu.solver` on one device).

Parity: reference ``raocp/core/solver.py:12`` (``Solver.chock``). As the
JAX package's jitted ``while_loop`` does, the loop keeps its state on the
device and runs a check period at a time (:func:`_device_loop`): on a card
each period is a replay of a captured CUDA graph and the host reads one
flag a period; on the CPU the same period runs eagerly. Like the JAX
package it carries L z and L'eta between iterations, so a step costs two
operator applies, plus one for the xi_0 residual at a check. Chunked
solves (:func:`_chunked_loop`), batch solves (:func:`_run_cp_batch`: B
initial states, every op on all lanes at once),
the accelerated loops (:mod:`raocp_tpu_torch.accel`) and the reporting
helpers (``validate``, plots, pgfplots exports) keep the JAX package's
semantics. Under a ``mesh`` the loop runs SPMD over ``torch.distributed``,
one process a rank, on the replicated-spine subtree partition
(:mod:`raocp_tpu_torch.parallel.subtree`) or the flat node partition
(:mod:`raocp_tpu_torch.parallel.flat`), whose collectives are staged on the
host: they run the host loop (:func:`_run_cp_host`), which reads the device
at every check.
"""

import contextlib
import dataclasses
import functools
import math
import os
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.core.stacked import (StackedProblem, _dedup_dynamics,
                                          _torch_dtype, build_stacked,
                                          default_dtype)
from raocp_tpu_torch.core.variables import (Dual, Primal, lane_view,
                                            tree_add, tree_dot,
                                            tree_inf_norm, tree_sub)
from raocp_tpu_torch.ops import prox as prox_mod
from raocp_tpu_torch.ops import sweep as sweep_mod
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import (g_conj_projections, half_shift_dual,
                                      prox_f)
from raocp_tpu_torch.ops.sweep import DeviceFault
from raocp_tpu_torch.parallel.flat import FlatProblem
from raocp_tpu_torch.parallel.sharding import (all_reduce, mesh_device,
                                               shard_problem)
from raocp_tpu_torch.parallel.subtree import (build_subtree_problem,
                                              choose_frontier)

__all__ = ["Solver", "SolverResult", "cp_iteration", "pin_full_precision"]

# The faults a chunked solve retries once from its host snapshot: a failed
# K1 launch, a CUDA runtime fault, and running out of device memory. Errors
# of the caller (ValueError, TypeError, ...) are never caught.
_DEVICE_FAULTS = tuple(c for c in (DeviceFault,
                                   getattr(torch, "AcceleratorError", None),
                                   torch.cuda.OutOfMemoryError)
                       if c is not None)


def pin_full_precision() -> None:
    """Full-float32 matmuls: no TF32 in cuBLAS or cuDNN, "highest" float32
    matmul precision. TF32 keeps about three decimal digits, and reduced
    precision stalls CP around xi ~ 1e-2, above the solver's tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class SolverResult:
    """Outcome of one Chambolle-Pock solve (iterates as NumPy arrays)."""
    status: int                 # 0 = converged, 1 = max iterations reached
    num_iters: int              # CP steps executed
    xi: np.ndarray              # final [xi_0, xi_1, xi_2]
    xi_history: np.ndarray      # [num_iters, 3]
    delta_history: np.ndarray   # [num_iters, 3]
    alpha: float                # primal/dual step size used
    solve_time: float           # wall-clock seconds of the loop
    primal: Primal              # final primal (NumPy arrays)
    dual: Dual                  # final dual

    @property
    def converged(self) -> bool:
        return self.status == 0

    @property
    def objective(self) -> float:
        """The optimal cost: the root epigraph variable s_0 of the nested
        risk recursion."""
        return float(np.asarray(self.primal.s)[0])

    @property
    def iters_per_second(self) -> float:
        return self.num_iters / self.solve_time if self.solve_time else 0.0

    def save_checkpoint(self, path: str) -> None:
        """Persist (z, eta, k) in the JAX package's npz layout, so either
        package can warm-start from it. One writer
        (:func:`_write_iterate_npz`) serves this and the fault checkpoints
        of chunked solves."""
        _write_iterate_npz(self.primal, self.dual, self.num_iters, path)

    @staticmethod
    def load_checkpoint(path: str):
        """Return (primal, dual, num_iters) from :meth:`save_checkpoint`
        (or from the JAX package's checkpoints)."""
        data = np.load(path)
        primal = Primal(**{k: data[f"primal_{k}"] for k in Primal._fields})
        dual = Dual(**{k: data[f"dual_{k}"] for k in Dual._fields})
        return primal, dual, int(data["num_iters"])


def _normalise(z, norm):
    return type(z)(*(v / norm for v in z))


def _sp_primal_dot(sp: StackedProblem, a, b):
    """<a, b> over primal trees, also under the subtree partition (JAX
    ``solver.py:113``): there the spine rows [0, stage_start[frontier]) of
    every leaf are replicated on all ranks, so the global inner product is
    the all-reduced sum of the local ones with the spine rows weighted by
    1/D. Under the flat partition every row lives on one rank (ghost rows
    are zero), so it is the all-reduced sum. :func:`tree_dot` outside a
    partition."""
    if sp.spmd_group is None:
        return tree_dot(a, b)
    if sp.flat is not None:
        local = tree_dot(a, b)
    else:
        spine = sp.stage_start[sp.frontier]
        scale = 1.0 - 1.0 / sp.spmd_ndev
        local = torch.stack([
            torch.vdot(x.reshape(-1), y.reshape(-1))
            - scale * torch.vdot(x[:spine].reshape(-1),
                                 y[:spine].reshape(-1))
            for x, y in zip(a, b)]).sum()
    return all_reduce(local.reshape(1), dist.ReduceOp.SUM,
                      sp.spmd_group)[0]


def _power_iteration(sp: StackedProblem, max_iters: int = 10000,
                     rel_tol: float = 1e-12):
    """lambda_max(L'L) by power iteration on the primal space, started from
    ``numpy.random.default_rng(0)`` normals (one draw per leaf, in leaf
    order). Returns (lambda as float, iterations). Under the subtree
    partition every rank draws the same normals for its local shapes, so
    the replicated spine rows start alike; under the flat partition each
    rank takes its block of the single-device draws. The convergence test
    reads an all-reduced value, the same on every rank."""
    rng = np.random.default_rng(0)
    if sp.flat is not None:
        z = FlatProblem(sp).power_start(rng)
    else:
        z = Primal(*(torch.as_tensor(rng.standard_normal(tuple(l.shape)),
                                     dtype=sp.dtype, device=sp.device)
                     for l in sp.zero_primal()))
    z = _normalise(z, torch.sqrt(_sp_primal_dot(sp, z, z)))
    lam, lam_prev = 0.0, -1.0
    k = 0
    while (k < 2 or abs(lam - lam_prev) > rel_tol * abs(lam)) \
            and k < max_iters:
        w = ell_t(sp, ell(sp, z))
        # Rayleigh quotient
        lam_prev, lam = lam, float(_sp_primal_dot(sp, z, w))
        z = _normalise(w, torch.sqrt(_sp_primal_dot(sp, w, w)))
        k += 1
    return lam, k


def _cp_step(sp: StackedProblem, z, eta, Lz, Lt, alpha1, alpha2, x0,
             shift=None):
    """One Chambolle-Pock step (no residuals); carries L z and L'eta so a
    step costs two operator applies. ``shift`` is
    :func:`half_shift_dual` (computed here when not given). In a batch the
    iterates carry a lane axis, x0 is [B, n] and the step sizes are
    numbers or per lane [B]."""
    if shift is None:
        shift = half_shift_dual(sp)
    # primal: z+ = prox_f(z - a1 L'eta)
    z_new = prox_f(sp, Primal(*(zi - lane_view(alpha1, ti) * ti
                                for zi, ti in zip(z, Lt))), alpha1, x0)
    Lzn = ell(sp, z_new)
    # dual: eta+ = prox_g*(eta + a2 L(2 z+ - z)) via Moreau
    a2 = [lane_view(alpha2, e) for e in eta]
    mod = Dual(*((e + a * (2.0 * lzn - lz)) / a + s
                 for e, a, lzn, lz, s in zip(eta, a2, Lzn, Lz, shift)))
    proj = g_conj_projections(sp, mod)
    eta_new = Dual(*(a * (m - p) for a, m, p in zip(a2, mod, proj)))
    Ltn = ell_t(sp, eta_new)
    return z_new, eta_new, Lzn, Ltn


def _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha1, alpha2):
    """The xi_0/1/2 and delta_0/1/2 max-norms of one step (reference
    solver.py:63-95) as two 3-element tensors, or [B, 3] for the lanes of
    a batch (no host sync). Costs one extra operator apply (L' of xi_2)."""
    lanes = z.x.dim() == 3
    xi1 = Primal(*((a - b) / lane_view(alpha1, a) - (c - d)
                   for a, b, c, d in zip(z, zn, Lt, Ltn)))
    xi2 = Dual(*((a - b) / lane_view(alpha2, a) + (c - d)
                 for a, b, c, d in zip(eta, en, Lzn, Lz)))
    xi0 = tree_add(xi1, ell_t(sp, xi2))
    d1 = tree_sub(zn, z)
    d2 = tree_sub(en, eta)
    d0 = Primal(*(a - (b - c) for a, b, c in zip(d1, Ltn, Lt)))
    err = torch.stack([tree_inf_norm(xi0, lanes), tree_inf_norm(xi1, lanes),
                       tree_inf_norm(xi2, lanes)], dim=-1)
    derr = torch.stack([tree_inf_norm(d0, lanes), tree_inf_norm(d1, lanes),
                        tree_inf_norm(d2, lanes)], dim=-1)
    if sp.spmd_group is not None:
        # a partition: local max-norms -> global (rows are owned once or
        # replicated, ghost rows zero, so a max is exact); one all-reduce
        # for all six norms (of every lane in a batch)
        both = all_reduce(torch.cat([err, derr], dim=-1), dist.ReduceOp.MAX,
                          sp.spmd_group)
        err, derr = both[..., :3], both[..., 3:]
    return err, derr


def cp_iteration(sp: StackedProblem, z, eta, Lz, Lt, alpha1, alpha2, x0,
                 shift=None):
    """One full Chambolle-Pock step and its residuals (three operator
    applies in all; JAX ``solver.py:230``): :func:`_cp_step` followed by
    :func:`_cp_residuals`. Returns (z+, eta+, L z+, L'eta+, err, derr),
    err and derr the [xi_0, xi_1, xi_2] and [delta_0, delta_1, delta_2]
    max-norms. ``shift`` is :func:`half_shift_dual` (computed when not
    given)."""
    zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, alpha1, alpha2, x0,
                                shift)
    err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha1,
                              alpha2)
    return zn, en, Lzn, Ltn, err, derr

# 'auto' over-relaxation factor (the JAX package's measured default for
# long solves); plain solve() keeps relax=1.0 for reference parity
_AUTO_RELAX = 1.8

# residual-balancing constants (Goldstein et al. 2013 defaults)
_ADAPT_DELTA = 1.5    # imbalance ratio that triggers a rebalance
_ADAPT_PHI = 0.5      # initial step-change intensity
_ADAPT_DECAY = 0.95   # phi decay per rebalance


def _resolve_relax(relax) -> float:
    if isinstance(relax, str):
        if relax != "auto":
            raise ValueError(f"unknown relax '{relax}' (float or 'auto')")
        return _AUTO_RELAX
    return float(relax)


def _rebalance(a1, a2, phi, err):
    """One residual-balancing update of (alpha1, alpha2, phi) (tensors; per
    lane, [B], against err [B, 3] in a batch)."""
    grow = err[..., 1] > _ADAPT_DELTA * err[..., 2]   # primal dominates
    shrink = err[..., 2] > _ADAPT_DELTA * err[..., 1]  # dual dominates
    one = torch.ones_like(phi)
    fac = torch.where(grow, 1.0 / (1.0 - phi),
                      torch.where(shrink, 1.0 - phi, one))
    phi_new = torch.where(grow | shrink, phi * _ADAPT_DECAY, phi)
    return a1 * fac, a2 / fac, phi_new


def _log_residuals(k, err):
    print(f"[raocp_tpu_torch] iter {int(k):>7d}  "
          f"xi_0={float(err[0]):.3e} xi_1={float(err[1]):.3e} "
          f"xi_2={float(err[2]):.3e}")


# What the CP loops ran, summed since import (read deltas around a run, as
# for ``ops.sweep.LAUNCHES``). ``host_reads`` counts the host's reads of
# the device inside a loop: a check's residuals in the host loops, a
# period's flag (and a logged period's rows) in the device loop. The rest
# is the device loop's: periods (eager or replayed), of them graph replays;
# captures and their seconds (the eager first period and both graphs); CP
# steps run on the device, and of them those run past convergence (the
# period enqueued ahead of the flag that stopped the loop) and those that
# replays ran. A replayed step is a prox_f call that Python made once, at
# capture (``scripts.bench_configs.counted_calls`` adds them to its count).
LOOP_COUNTS = dict(periods=0, replays=0, captures=0, capture_seconds=0.0,
                   host_reads=0, steps=0, wasted_steps=0, replayed_steps=0)


def _run_cp_host(sp: StackedProblem, z0, eta0, x0, alpha1, alpha2, tol,
                 max_iters: int, check_every: int = 1, unroll: int = 1,
                 adaptive: bool = False, relax: float = 1.0,
                 log_every: Optional[int] = None, k0: int = 0):
    """The CP loop driven from the host, step by step, with the JAX
    package's semantics: the loop of the partitions, whose collectives are
    staged on the host (:func:`_run_cp` runs the single device's). Returns
    (z, eta, iters, final errors as NumPy [3], history NumPy [iters, 6]).

    ``log_every=j`` prints the last checked residuals after every step
    whose loop index is a multiple of j (JAX ``solver.py:442``), with the
    index offset by ``k0`` (the iterations of earlier chunks); it reads
    nothing from the device beyond the checks. Under the subtree partition
    the residuals are all-reduced, the same on every rank, and only rank 0
    prints.

    ``check_every=k`` evaluates the residuals (and the stopping test) only
    at every k-th iteration; unchecked history rows are NaN (all rows are
    written when k = 1). ``unroll=u`` is the number of steps per loop trip:
    the stopping test runs after each trip, so the iteration cap is
    ``k + u < max_iters + 2`` as in the JAX loop (u must divide
    check_every, or be 1). ``adaptive`` rebalances alpha1/alpha2 at each
    check keeping their product; ``relax=rho`` over-relaxes each step after
    the residual evaluation (Condat). The host reads the device only at a
    check.
    """
    if unroll > 1 and check_every % unroll != 0:
        raise ValueError("unroll must divide check_every")
    dt, dev = sp.dtype, sp.device
    z, eta = Primal(*z0), Dual(*eta0)
    Lz = ell(sp, z)
    Lt = ell_t(sp, eta)
    shift = half_shift_dual(sp)
    a1 = torch.as_tensor(alpha1, dtype=dt, device=dev)
    a2 = torch.as_tensor(alpha2, dtype=dt, device=dev)
    phi = torch.as_tensor(_ADAPT_PHI, dtype=dt, device=dev)
    hist = np.full((max_iters + unroll, 6),
                   0.0 if check_every == 1 else np.nan)
    err_np = np.full(3, np.inf)
    if sp.spmd_group is not None and dist.get_rank(sp.spmd_group) != 0:
        log_every = None
    k = 0
    while k == 0 or (err_np.max() > tol and k + unroll < max_iters + 2):
        for i in range(unroll):
            zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, a1, a2, x0,
                                        shift)
            if check_every == 1 or (k + i + 1) % check_every == 0:
                err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt,
                                          Ltn, a1, a2)
                if adaptive:
                    a1, a2, phi = _rebalance(a1, a2, phi, err)
                row = torch.cat([err, derr]).cpu().numpy()   # the one sync
                LOOP_COUNTS["host_reads"] += 1
                hist[k + i] = row
                err_np = row[:3]
            if log_every is not None and (k + i) % log_every == 0:
                _log_residuals(k0 + k + i, err_np)
            if relax != 1.0:
                # over-relaxation after the residual evaluation; the carried
                # operator images relax linearly
                z, eta, Lz, Lt = (
                    type(cur)(*(c + relax * (p - c) for c, p in zip(cur, nw)))
                    for cur, nw in ((z, zn), (eta, en), (Lz, Lzn), (Lt, Ltn)))
            else:
                z, eta, Lz, Lt = zn, en, Lzn, Ltn
        k += unroll
    return z, eta, k, err_np, hist[:k]


def _running_lanes(keep, new, old):
    """``new`` on the lanes that ``keep`` ([B] bool, or None for all) marks
    running, ``old`` on the others, leaf by leaf."""
    if keep is None:
        return new
    kept = [torch.where(lane_view(keep, o), nw, o) for nw, o in zip(new, old)]
    return type(old)(*kept) if isinstance(old, (Primal, Dual)) \
        else tuple(kept)


def _run_cp_batch_host(sp: StackedProblem, z0, eta0, x0s, alpha1, alpha2,
                       tol, max_iters: int, check_every: int = 1,
                       unroll: int = 1, adaptive: bool = False,
                       relax: float = 1.0):
    """The CP loop of :func:`_run_cp_host` for B lanes at once (the JAX
    package's ``jax.vmap`` of its loop): the iterates carry a leading lane
    axis, x0s is [B, n], and every step of every operator is one call for
    all lanes. Returns (z, eta, iters [B], final errors [B, 3], history
    [B, max_iters + unroll, 6]).

    Each lane keeps the semantics of its own solve. Its loop condition
    (``k == 0`` or its last checked residual above ``tol`` and ``k +
    unroll < max_iters + 2``) is read on the host after every trip, from
    the one sync a check makes ([B, 6]); once it is false the lane keeps
    its carry through ``torch.where`` (its steps, with ``adaptive``, too),
    writes no more history and stops counting, and the loop ends when no
    lane runs. Lanes are never taken out of the batch: the shapes, and so
    every lane's arithmetic, stay those of the first step.
    """
    if unroll > 1 and check_every % unroll != 0:
        raise ValueError("unroll must divide check_every")
    dt, dev = sp.dtype, sp.device
    lanes = x0s.shape[0]
    z, eta = Primal(*z0), Dual(*eta0)
    Lz = ell(sp, z)
    Lt = ell_t(sp, eta)
    shift = half_shift_dual(sp)
    # one step size for all lanes, unless a rebalance gives each its own
    steps = (lanes,) if adaptive else ()
    a1 = torch.full(steps, alpha1, dtype=dt, device=dev)
    a2 = torch.full(steps, alpha2, dtype=dt, device=dev)
    phi = torch.full(steps, _ADAPT_PHI, dtype=dt, device=dev)
    hist = np.full((lanes, max_iters + unroll, 6),
                   0.0 if check_every == 1 else np.nan)
    err_np = np.full((lanes, 3), np.inf)
    iters = np.zeros(lanes, dtype=np.int64)
    running = np.ones(lanes, dtype=bool)
    k = 0
    while running.any():
        keep = None if running.all() else torch.as_tensor(running, device=dev)
        for i in range(unroll):
            zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, a1, a2, x0s,
                                        shift)
            if check_every == 1 or (k + i + 1) % check_every == 0:
                err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt,
                                          Ltn, a1, a2)
                if adaptive:
                    a1, a2, phi = _running_lanes(
                        keep, _rebalance(a1, a2, phi, err), (a1, a2, phi))
                rows = torch.cat([err, derr], dim=1).cpu().numpy()  # sync
                LOOP_COUNTS["host_reads"] += 1
                hist[running, k + i] = rows[running]
                err_np[running] = rows[running, :3]
            if relax != 1.0:
                new = [type(cur)(*(c + relax * (p - c)
                                   for c, p in zip(cur, nw)))
                       for cur, nw in ((z, zn), (eta, en), (Lz, Lzn),
                                       (Lt, Ltn))]
            else:
                new = (zn, en, Lzn, Ltn)
            z, eta, Lz, Lt = (_running_lanes(keep, nw, cur) for nw, cur
                              in zip(new, (z, eta, Lz, Lt)))
        k += unroll
        iters[running] = k
        running &= (err_np.max(axis=1) > tol) & (k + unroll < max_iters + 2)
    return z, eta, iters, err_np, hist


# -- the device-resident loop (JAX: _run_cp's jitted while_loop) -----------

# set only inside _host_loop()
_HOST_LOOP = False
# the loop of each problem on a card: id(sp) -> (key, _DeviceLoop)
_LOOPS = {}


@contextlib.contextmanager
def _host_loop():
    """Within the block :func:`_run_cp` and :func:`_run_cp_batch` run the
    host loops (:func:`_run_cp_host`, :func:`_run_cp_batch_host`): the
    switch of an A/B of the two loops (``chip_smoke.py``'s ``loop_graph``,
    ``scripts/bench_sweep.py``). The previous state returns on exit, also
    on an exception."""
    global _HOST_LOOP
    saved = _HOST_LOOP
    _HOST_LOOP = True
    try:
        yield
    finally:
        _HOST_LOOP = saved


def _lookahead(device: torch.device) -> int:
    """Periods enqueued ahead of the flag the host reads: one on a card (it
    never waits for the host), none on the CPU (nothing runs ahead)."""
    return 1 if device.type == "cuda" else 0


def _trip_cap(max_iters: int, unroll: int) -> int:
    """The step count at which the loop's cap stops it: the first trip
    always runs, later ones while k + unroll < max_iters + 2."""
    return max(unroll, unroll * -(-(max_iters + 2 - unroll) // unroll))


@dataclasses.dataclass
class _Carry:
    """One set of the loop's state on the device: the iterates and their
    operator images, the step sizes and phi, the last checked residuals,
    the step count and the running flag; in a batch the flag is [B] and
    ``iters`` each lane's count."""
    z: Primal
    eta: Dual
    Lz: Dual
    Lt: Primal
    a1: torch.Tensor
    a2: torch.Tensor
    phi: torch.Tensor
    err: torch.Tensor
    derr: torch.Tensor
    k: torch.Tensor
    running: torch.Tensor
    iters: Optional[torch.Tensor] = None

    def parts(self):
        """What a period carries, each as a tuple of leaves."""
        return (self.z, self.eta, self.Lz, self.Lt, (self.a1,), (self.a2,),
                (self.phi,), (self.err,), (self.derr,))


def _store(dst, new, old, keep):
    """``dst`` <- ``new`` leaf by leaf; in a batch (``keep`` [B]) only on
    the running lanes, ``old`` on the others (a number shared by every
    lane never changes)."""
    for d, n, o in zip(dst, new, old):
        if keep is None or n.dim() == 0:
            d.copy_(n)
        else:
            torch.where(lane_view(keep, n), n, o, out=d)


def _period(sp: StackedProblem, src: _Carry, dst: _Carry, steps: int,
            checked: bool, adaptive: bool, relax: float, x0, shift, hist,
            tol, limit):
    """``steps`` CP steps from ``src`` into ``dst`` with no host read (the
    JAX loop's body over a period; what a CUDA graph captures). With
    ``checked`` the last step is a check (a period of ``check_every``
    steps; the tail has none): its residuals are evaluated, rebalance the
    steps under ``adaptive`` and write their [err, derr] row of ``hist``
    at the device's count (``index_copy_``). ``relax`` over-relaxes each
    step after its residuals. ``running`` then
    takes the loop's condition: the last checked residual above ``tol``
    (compared in float64, as on the host) and k + unroll < max_iters + 2
    (k < ``limit``).

    In a batch (``src.iters`` set) the lanes that ``src.running`` marks
    move; the others keep their carry, rows, count and flag. The mask is
    constant over a period and the lanes' arithmetic is independent, so
    one :func:`_store` at its end gives the host loop's per-step masking
    (:func:`_running_lanes`)."""
    keep = src.running if src.iters is not None else None
    z, eta, Lz, Lt = src.z, src.eta, src.Lz, src.Lt
    a1, a2, phi, err, derr = src.a1, src.a2, src.phi, src.err, src.derr
    for i in range(steps):
        zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, a1, a2, x0, shift)
        if checked and i == steps - 1:
            err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn,
                                      a1, a2)
            if adaptive:
                a1, a2, phi = _rebalance(a1, a2, phi, err)
            row = torch.cat([err, derr], dim=-1)
            at = (src.k + i).reshape(1)
            if keep is None:
                hist.index_copy_(0, at, row[None])
            else:
                # a stopped lane's rows keep what they hold
                hist.index_copy_(1, at, torch.where(
                    keep[:, None, None], row[:, None],
                    hist.index_select(1, at)))
        if relax != 1.0:
            z, eta, Lz, Lt = (
                type(cur)(*(c + relax * (p - c) for c, p in zip(cur, nw)))
                for cur, nw in ((z, zn), (eta, en), (Lz, Lzn), (Lt, Ltn)))
        else:
            z, eta, Lz, Lt = zn, en, Lzn, Ltn
    k = src.k + steps
    for d, n, o in zip(dst.parts(), (z, eta, Lz, Lt, (a1,), (a2,), (phi,),
                                     (err,), (derr,)), src.parts()):
        _store(d, n, o, keep)
    dst.k.copy_(k)
    dst.running.copy_(src.running & (err.double().amax(dim=-1) > tol)
                      & (k < limit))
    if keep is not None:
        torch.where(keep, k, src.iters, out=dst.iters)


class _DeviceLoop:
    """The device loop's buffers for one problem and one shape of period:
    two carries that periods alternate between (0 -> 1, then 1 -> 0, so a
    period run past convergence never overwrites the converged one), the
    history, x0, tol and the cap; on a card the two CUDA graphs of a
    period, captured at first use, and the pinned flags the host reads."""

    def __init__(self, sp, z0, eta0, Lz0, Lt0, lanes: Optional[int],
                 steps: int, adaptive: bool, relax: float, capacity: int):
        dev, dt = sp.device, sp.dtype
        lead = () if lanes is None else (lanes,)
        step_shape = lead if adaptive else ()

        def like(tree):
            return type(tree)(*(torch.empty_like(
                v, memory_format=torch.contiguous_format) for v in tree))

        def carry():
            return _Carry(
                z=like(z0), eta=like(eta0), Lz=like(Lz0), Lt=like(Lt0),
                **{name: torch.empty(step_shape, dtype=dt, device=dev)
                   for name in ("a1", "a2", "phi")},
                err=torch.empty(lead + (3,), dtype=dt, device=dev),
                derr=torch.empty(lead + (3,), dtype=dt, device=dev),
                k=torch.zeros((), dtype=torch.int64, device=dev),
                running=torch.ones(lead, dtype=torch.bool, device=dev),
                iters=None if lanes is None else torch.zeros(
                    lead, dtype=torch.int64, device=dev))

        self.sets = (carry(), carry())
        self.hist = torch.empty(lead + (capacity, 6), dtype=dt, device=dev)
        self.x0 = torch.empty(lead + (sp.n,), dtype=dt, device=dev)
        self.tol = torch.zeros((), dtype=torch.float64, device=dev)
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.shift = half_shift_dual(sp)
        self.steps, self.adaptive, self.relax = steps, adaptive, relax
        self.graphs = None
        self.k1_per_period = 0
        if dev.type == "cuda":
            self.flags = [torch.empty(lead, dtype=torch.bool,
                                      pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]

    def load(self, z0, eta0, Lz0, Lt0, x0, alpha1, alpha2, tol, limit,
             rows, fill):
        """Start a solve: carry 0 from the inputs, the history's first
        ``rows`` rows set to ``fill``."""
        c = self.sets[0]
        for dst, src in ((c.z, z0), (c.eta, eta0), (c.Lz, Lz0),
                         (c.Lt, Lt0)):
            for d, s in zip(dst, src):
                d.copy_(s)
        c.a1.fill_(alpha1)
        c.a2.fill_(alpha2)
        c.phi.fill_(_ADAPT_PHI)
        c.err.fill_(math.inf)
        c.derr.fill_(math.inf)
        c.k.zero_()
        c.running.fill_(True)
        if c.iters is not None:
            c.iters.zero_()
        self.hist[..., :rows, :].fill_(fill)
        self.x0.copy_(x0)
        self.tol.fill_(float(tol))
        self.limit.fill_(limit)

    def run_period(self, sp, parity: int, steps: Optional[int] = None):
        """One period from carry ``parity`` into the other, eagerly; with
        ``steps``, the tail: that many steps and no check."""
        _period(sp, self.sets[parity], self.sets[1 - parity],
                self.steps if steps is None else steps, steps is None,
                self.adaptive, self.relax, self.x0, self.shift, self.hist,
                self.tol, self.limit)

    def capture(self, sp):
        """Run period 0 eagerly on a side stream (it builds K1's library,
        packs its weights and grows the allocator, outside any graph), then
        capture a period from each carry into the other, sharing one
        memory pool (they never run at once). The K1 launches recorded in
        a graph are what each of its replays adds to
        ``ops.sweep.LAUNCHES``."""
        tic = time.perf_counter()
        side = torch.cuda.Stream(sp.device)
        side.wait_stream(torch.cuda.current_stream(sp.device))
        with torch.cuda.stream(side):
            self.run_period(sp, 0)
        torch.cuda.current_stream(sp.device).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for parity in (0, 1):
            graph = torch.cuda.CUDAGraph()
            recorded = sweep_mod.RECORDED
            with torch.cuda.graph(graph, pool=pool, stream=side):
                self.run_period(sp, parity)
            self.k1_per_period = sweep_mod.RECORDED - recorded
            graphs.append(graph)
        self.graphs = graphs
        LOOP_COUNTS["captures"] += 1
        LOOP_COUNTS["capture_seconds"] += time.perf_counter() - tic

    def launch(self, sp, n: int):
        """Period ``n`` (from carry n % 2): a graph replay, or on the first
        use of a card's loop its capture; eagerly on the CPU. On a card its
        flag then goes to pinned memory behind an event."""
        parity = n % 2
        if sp.device.type != "cuda":
            self.run_period(sp, parity)
        elif self.graphs is None:
            self.capture(sp)            # period 0 runs eagerly in it
        else:
            self.graphs[parity].replay()
            LOOP_COUNTS["replays"] += 1
            LOOP_COUNTS["replayed_steps"] += self.steps
            sweep_mod.LAUNCHES += self.k1_per_period
        LOOP_COUNTS["periods"] += 1
        LOOP_COUNTS["steps"] += self.steps
        if sp.device.type == "cuda":
            self.flags[parity].copy_(self.sets[1 - parity].running,
                                     non_blocking=True)
            self.events[parity].record()

    def flag(self, sp, n: int) -> np.ndarray:
        """Period ``n``'s running flag (the loop's condition after it), as
        the host reads it."""
        LOOP_COUNTS["host_reads"] += 1
        parity = n % 2
        if sp.device.type != "cuda":
            return self.sets[1 - parity].running.numpy().copy()
        self.events[parity].synchronize()
        return self.flags[parity].numpy().copy()


def _loop_for(sp, z0, eta0, Lz0, Lt0, lanes, steps, adaptive, relax,
              rows) -> _DeviceLoop:
    """The problem's device loop for this shape of period: on a card the
    cached one (one a problem, kept while the key holds, so a solver's
    later solves, chunks and closed-loop steps replay its graphs), else a
    new one. The key is what changes the captured program: the lanes, the
    period, ``adaptive``, ``relax``, the dynamics projection's
    dispatch (K1, the stage path, or a patched sweep) and the history's
    capacity (a power of two, at least 1,024 rows)."""
    capacity = max(1024, 1 << (rows - 1).bit_length())
    if sp.device.type != "cuda":
        return _DeviceLoop(sp, z0, eta0, Lz0, Lt0, lanes, steps, adaptive,
                           relax, rows)
    key = (lanes, steps, adaptive, relax, sweep_mod.sweep_eligible(sp),
           prox_mod.project_dynamics_sweep, capacity)
    cached = _LOOPS.get(id(sp))
    if cached is not None and cached[0] == key:
        return cached[1]
    if id(sp) not in _LOOPS:
        weakref.finalize(sp, _LOOPS.pop, id(sp), None)
    _LOOPS[id(sp)] = None           # drop the old loop's memory first
    loop = _DeviceLoop(sp, z0, eta0, Lz0, Lt0, lanes, steps, adaptive,
                       relax, capacity)
    _LOOPS[id(sp)] = (key, loop)
    return loop


def _device_loop(sp, z0, eta0, x0, alpha1, alpha2, tol, max_iters,
                 check_every, unroll, adaptive, relax, log_every=None,
                 k0=0, lanes=None):
    """The CP loop with its state on the device (the JAX package's jitted
    ``while_loop``): a period is ``check_every`` steps, its last a check
    (``unroll`` divides it, or is 1 at ``check_every=1``), so the tolerance
    can stop the loop only at a period's end, and the host reads one flag
    a period. On a card each
    period is a replay of a captured CUDA graph, the next one enqueued
    before the host reads the last one's flag; on the CPU it runs eagerly.
    The cap is known to the host: full periods up to it, then the tail's
    steps (no check falls in them) eagerly. Returns (the final carry, the
    steps taken, the loop)."""
    if unroll > 1 and check_every % unroll != 0:
        raise ValueError("unroll must divide check_every")
    steps = check_every
    cap = _trip_cap(max_iters, unroll)
    full, tail = divmod(cap, steps)
    z0, eta0 = Primal(*z0), Dual(*eta0)
    Lz0, Lt0 = ell(sp, z0), ell_t(sp, eta0)
    rows = max_iters + unroll
    fill = 0.0 if check_every == 1 else math.nan
    with (torch.cuda.device(sp.device) if sp.device.type == "cuda"
          else contextlib.nullcontext()):
        loop = _loop_for(sp, z0, eta0, Lz0, Lt0, lanes, steps, adaptive,
                         relax, rows)
        loop.load(z0, eta0, Lz0, Lt0, x0, alpha1, alpha2, tol,
                  max_iters + 2 - unroll, rows, fill)
        ahead = _lookahead(sp.device)
        err_np = np.full(3, np.inf)
        done = 0
        stopped = False
        if full:
            loop.launch(sp, 0)
        for n in range(full):
            if ahead and n + 1 < full:
                loop.launch(sp, n + 1)
            running = loop.flag(sp, n).any()
            done = n + 1
            if log_every is not None:
                err_np = _log_period(loop.hist, n * steps, steps, True,
                                     log_every, k0, err_np)
            if not running:
                stopped = True
                if ahead and n + 1 < full:
                    LOOP_COUNTS["wasted_steps"] += steps
                break
            if not ahead and n + 1 < full:
                loop.launch(sp, n + 1)
        k = done * steps
        final = loop.sets[done % 2]
        if not stopped and tail:
            loop.run_period(sp, done % 2, tail)
            LOOP_COUNTS["steps"] += tail
            if log_every is not None:
                _log_period(loop.hist, k, tail, False, log_every, k0,
                            err_np)
            k += tail
            final = loop.sets[(done + 1) % 2]
    return final, k, loop


def _log_period(hist, start, steps, checked, log_every, k0, err_np):
    """``log_every``'s lines of the steps [start, start + steps), in the
    host loop's order: each step's index with the last residuals checked at
    or before it. Reads the check's row of a ``checked`` period; returns
    the last checked residuals."""
    for j in range(start, start + steps):
        if checked and j == start + steps - 1:
            err_np = hist[j, :3].cpu().numpy()
            LOOP_COUNTS["host_reads"] += 1
        if j % log_every == 0:
            _log_residuals(k0 + j, err_np)
    return err_np


def _run_cp(sp: StackedProblem, z0, eta0, x0, alpha1, alpha2, tol,
            max_iters: int, check_every: int = 1, unroll: int = 1,
            adaptive: bool = False, relax: float = 1.0,
            log_every: Optional[int] = None, k0: int = 0):
    """The CP loop with the JAX package's semantics, its state on the
    device (:func:`_device_loop`). Returns (z, eta, iters, final errors as
    NumPy [3], history NumPy [iters, 6]): the same iterates, count and
    history rows as :func:`_run_cp_host`, bit for bit.

    ``log_every=j`` prints the last checked residuals after every step
    whose loop index is a multiple of j (JAX ``solver.py:442``), with the
    index offset by ``k0`` (the iterations of earlier chunks): the host
    loop's lines in its order, printed as each period's flag is read.

    ``check_every=k`` evaluates the residuals (and the stopping test) only
    at every k-th iteration; unchecked history rows are NaN (all rows are
    written when k = 1). ``unroll=u`` is the number of steps per loop trip:
    the iteration cap is ``k + u < max_iters + 2`` as in the JAX loop (u
    must divide check_every, or be 1); at ``check_every=1`` a period is u
    steps. ``adaptive`` rebalances alpha1/alpha2 at each check keeping
    their product; ``relax=rho`` over-relaxes each step after the residual
    evaluation (Condat).

    On a card the loop captures its periods as CUDA graphs (cached per
    problem) and a capture or replay that fails raises; nothing reruns on
    the host. Inside :func:`_host_loop` it is :func:`_run_cp_host`."""
    if _HOST_LOOP:
        return _run_cp_host(sp, z0, eta0, x0, alpha1, alpha2, tol,
                            max_iters, check_every, unroll, adaptive, relax,
                            log_every, k0)
    if sp.spmd_group is not None:
        raise ValueError("a partition's collectives are staged on the "
                         "host: its loop is _run_cp_host")
    final, k, loop = _device_loop(sp, z0, eta0, x0, alpha1, alpha2, tol,
                                  max_iters, check_every, unroll, adaptive,
                                  relax, log_every, k0)
    cached = sp.device.type == "cuda"
    z = Primal(*(v.clone() if cached else v for v in final.z))
    eta = Dual(*(v.clone() if cached else v for v in final.eta))
    hist = loop.hist[:k].cpu().numpy().astype(np.float64)
    err = final.err.cpu().numpy()
    return z, eta, k, err, hist


def _run_cp_batch(sp: StackedProblem, z0, eta0, x0s, alpha1, alpha2, tol,
                  max_iters: int, check_every: int = 1, unroll: int = 1,
                  adaptive: bool = False, relax: float = 1.0):
    """The CP loop of :func:`_run_cp` for B lanes at once (the JAX
    package's ``jax.vmap`` of its loop): the iterates carry a leading lane
    axis, x0s is [B, n], and every step of every operator is one call for
    all lanes. Returns (z, eta, iters [B], final errors [B, 3], history
    [B, max_iters + unroll, 6]).

    Each lane keeps the semantics of its own solve, as in
    :func:`_run_cp_batch_host`: once its loop condition is false it keeps
    its carry, writes no more history and stops counting; the loop ends
    when no lane runs, which the host reads as one [B] flag a period.
    Lanes are never taken out of the batch. Inside :func:`_host_loop` it is
    :func:`_run_cp_batch_host`."""
    if _HOST_LOOP:
        return _run_cp_batch_host(sp, z0, eta0, x0s, alpha1, alpha2, tol,
                                  max_iters, check_every, unroll, adaptive,
                                  relax)
    if sp.spmd_group is not None:
        raise ValueError("a partition's collectives are staged on the "
                         "host: its loop is _run_cp_batch_host")
    final, _, loop = _device_loop(sp, z0, eta0, x0s, alpha1, alpha2, tol,
                                  max_iters, check_every, unroll, adaptive,
                                  relax, lanes=x0s.shape[0])
    cached = sp.device.type == "cuda"
    z = Primal(*(v.clone() if cached else v for v in final.z))
    eta = Dual(*(v.clone() if cached else v for v in final.eta))
    hist = loop.hist[:, :max_iters + unroll].cpu().numpy()
    return (z, eta, final.iters.cpu().numpy(), final.err.cpu().numpy(),
            hist.astype(np.float64))


def _to_numpy(tree):
    return type(tree)(*(v.detach().cpu().numpy() for v in tree))


def _chunked_loop(run_chunk, z0, eta0, tol, max_iters,
                  checkpoint_on_fault, write_checkpoint):
    """Drive a CP loop in chunks of a fixed budget, with one retry.

    ``run_chunk(z, eta, iters_done) -> (z, eta, it, err, hist)`` runs one
    chunk (JAX ``solver.py:241``); ``iters_done`` offsets its logged
    indices, so they are global. The iterates stay on the device between
    chunks, and each completed chunk's iterate is also copied to host
    memory. A device fault (:data:`_DEVICE_FAULTS`: a failed K1 launch, a
    CUDA runtime fault, or device memory running out; a fault during a
    graph replay surfaces at the next flag the host reads) mid-chunk retries
    that chunk once from the last host snapshot. If the retry fails too
    and ``checkpoint_on_fault`` is set, ``write_checkpoint(z_np, eta_np,
    iters, path)`` writes the snapshot before the error is raised.

    CUDA faults differ from XLA's: an illegal-address fault is sticky, the
    process's CUDA context is dead, and the retry fails as well. For such a
    fault the checkpoint is what saves the work: a fresh process resumes
    with ``solve(warm_start=SolverResult.load_checkpoint(path)[:2])``.
    """
    zc, ec = z0, eta0
    iters = 0
    hists = []
    snap = (_to_numpy(z0), _to_numpy(eta0), 0)
    retried = False
    while True:
        try:
            z, eta, it, err, hist = run_chunk(zc, ec, iters)
        except _DEVICE_FAULTS as e:
            if not retried:
                # redo this chunk from the last good host snapshot (its
                # history was never appended)
                retried = True
                zc, ec, iters = snap
                continue
            if checkpoint_on_fault is not None:
                zs, es, ks = snap
                write_checkpoint(zs, es, ks, checkpoint_on_fault)
                raise RuntimeError(
                    f"device fault persisted after retry; last good "
                    f"iterate (iteration {ks}) saved to "
                    f"{checkpoint_on_fault} — resume via "
                    "solve(warm_start=SolverResult."
                    "load_checkpoint(path)[:2])") from e
            raise
        retried = False
        iters += it
        hists.append(hist)
        snap = (_to_numpy(z), _to_numpy(eta), iters)
        if float(err.max()) <= tol or iters >= max_iters or it == 0:
            break
        zc, ec = z, eta          # device-resident warm start
    return z, eta, iters, err, np.concatenate(hists)


def _write_iterate_npz(z_np, eta_np, num_iters, path):
    """Persist (z, eta, k) in the SolverResult.save_checkpoint format."""
    primal = {f"primal_{k}": np.asarray(v) for k, v
              in Primal(*z_np)._asdict().items()}
    dual = {f"dual_{k}": np.asarray(v) for k, v
            in Dual(*eta_np)._asdict().items()}
    np.savez(path, num_iters=num_iters, **primal, **dual)


def _write_global_checkpoint(stp, z_np, eta_np, num_iters, path):
    """A partitioned solve's fault checkpoint: every rank's block gathered
    to the global node layout (so any partition, or none, resumes from it),
    written by rank 0 while the others wait at a barrier."""
    z = stp.primal_to_global(z_np)
    eta = stp.dual_to_global(eta_np)
    if stp.rank == 0:
        _write_iterate_npz(z, eta, num_iters, path)
    dist.barrier(stp.group)


# the card's tracer can lose every device record of a short trace (seen on
# an H100 in traces whose window began and ended next to their kernels, not
# since a trace of the card idles this long at both ends); single records
# lost inside a trace, which it also loses, no pad prevents
TRACE_PAD_S = 0.05


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: torch.device,
              name: str = "trace.json"):
    """``torch.profiler`` around the solve (CUDA activity only on a CUDA
    device, the card idle ``TRACE_PAD_S`` at both ends of the window), its
    Chrome trace written to ``profile_dir/name``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(TRACE_PAD_S)
        yield
        if cuda:
            torch.cuda.synchronize(device)
            time.sleep(TRACE_PAD_S)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, name))


def _host(v):
    return None if v is None else v.detach().cpu().numpy()


class Solver:
    """Builds the stacked problem + offline factorisations on ``device``,
    then solves with Chambolle-Pock.

    Building a Solver pins full-float32 matmul precision for the process
    (:func:`pin_full_precision`: TF32 off in cuBLAS and cuDNN, "highest"
    float32 matmul precision), which the solver needs to reach its
    tolerances in float32.

    ``device`` defaults to the card (``"cuda"``); without one the call
    raises, and nothing carries on on the CPU unless ``device="cpu"`` is
    passed. ``dtype`` defaults to float64 on the CPU and float32 on a GPU.

    :param mesh: a 1-D ``DeviceMesh`` over every rank
        (:func:`raocp_tpu_torch.parallel.make_mesh`), for a solve that runs
        SPMD: every rank builds the same Solver, holds its own block and
        returns the same global results. The device is the mesh's
        (``cuda:{current device}`` on a CUDA mesh); a ``device`` that
        names another raises.
    :param partition: the multi-rank layout (JAX ``solver.py:489``):

        * ``"subtree"``: the replicated-spine subtree partition
          (:mod:`raocp_tpu_torch.parallel.subtree`); needs a mesh of more
          than one rank and uniform branching below some stage. It runs
          neither ``accel`` nor :meth:`solve_batch`, as in JAX.
        * ``"flat"``: the flat node partition
          (:mod:`raocp_tpu_torch.parallel.flat`): every node space split in
          even row blocks, any tree, halo exchanges planned on the host;
          every option of :meth:`solve` and :meth:`solve_batch` runs.
        * ``"auto"`` (default): on a mesh of more than one rank, the
          subtree partition where the tree admits a frontier and
          ``pad_multiple`` is not given, the flat one otherwise; a one-rank
          mesh runs the single-device path.

        On the flat layout each node space is padded to a multiple of the
        rank count (of ``pad_multiple`` too, when given).
    """

    def __init__(self, problem_spec: RAOCP, dtype=None,
                 pad_multiple: Optional[int] = None, offline: str = "host",
                 mesh=None, partition: str = "auto", device="cuda"):
        if partition not in ("auto", "subtree", "flat"):
            raise ValueError(f"unknown partition '{partition}'")
        ranks = 1 if mesh is None else mesh.size()
        if partition == "subtree" and ranks < 2:
            raise ValueError(
                "partition='subtree' needs a mesh with more than one "
                "device (raocp_tpu_torch.parallel.make_mesh); otherwise the "
                "solve would silently run the single-device path")
        if partition == "subtree" and pad_multiple not in (None, 1):
            raise ValueError(
                "pad_multiple applies to the flat node layout only; the "
                "subtree partition pads stages to the device count "
                "internally — drop the argument or use partition='flat'")
        layout = None                       # the single-device path
        if mesh is not None:
            device = mesh_device(mesh, device)
            if partition == "flat":
                layout = "flat"
            elif ranks > 1:
                # eligibility is a function of the stage structure alone:
                # decided before any stacked build
                eligible = choose_frontier(problem_spec.tree,
                                           ranks) is not None
                if partition == "subtree" and not eligible:
                    raise ValueError(
                        "partition='subtree' needs uniform branching below "
                        "some stage; this tree is ragged everywhere — use "
                        "partition='flat'")
                layout = "subtree" if partition == "subtree" or (
                    eligible and pad_multiple is None) else "flat"
        pin_full_precision()
        self.__spec = problem_spec
        self.__part = None
        if layout is not None:
            # the global problem stays on the host; only this rank's blocks
            # go to the device
            dtype = default_dtype(device) if dtype is None \
                else _torch_dtype(dtype)
            if layout == "subtree":
                self.__stacked = build_stacked(
                    problem_spec, dtype=dtype, pad_multiple=1,
                    offline=offline, device="cpu")
                self.__part = build_subtree_problem(
                    problem_spec, mesh, dtype=dtype, offline=offline,
                    prebuilt=self.__stacked)
            else:
                self.__stacked = build_stacked(
                    problem_spec, dtype=dtype,
                    pad_multiple=math.lcm(ranks, pad_multiple or 1),
                    offline=offline, device="cpu")
                self.__part = FlatProblem(shard_problem(self.__stacked,
                                                        mesh))
        else:
            self.__stacked = build_stacked(
                problem_spec, dtype=dtype,
                pad_multiple=1 if pad_multiple is None else pad_multiple,
                offline=offline, device=device)
        self.__result: Optional[SolverResult] = None
        self.__lambda_max: Optional[float] = None
        self.__validate_plan: Optional[dict] = None
        self.power_iterations: Optional[int] = None

    def operator_norm_sq(self) -> float:
        """lambda_max(L'L), memoised per Solver."""
        if self.__lambda_max is None:
            lam, self.power_iterations = _power_iteration(
                self.__stacked if self.__part is None else self.__part.sp)
            self.__lambda_max = float(lam)
        return self.__lambda_max

    @property
    def stacked(self) -> StackedProblem:
        """The stacked problem; under a partition the global one, on the
        host (:attr:`subtree` or :attr:`flat` holds this rank's block)."""
        return self.__stacked

    @property
    def subtree(self):
        """The :class:`~raocp_tpu_torch.parallel.subtree.SubtreeProblem`
        when the solver runs the subtree partition, else None."""
        return None if isinstance(self.__part, FlatProblem) else self.__part

    @property
    def flat(self):
        """The :class:`~raocp_tpu_torch.parallel.flat.FlatProblem` when the
        solver runs the flat partition, else None."""
        return self.__part if isinstance(self.__part, FlatProblem) else None

    @property
    def spec(self) -> RAOCP:
        return self.__spec

    @property
    def result(self) -> Optional[SolverResult]:
        return self.__result

    def solve(self, initial_state, max_iters: int = 10, tol: float = 1e-5,
              alpha: Optional[float] = None, warm_start=None,
              log_every: Optional[int] = None,
              profile_dir: Optional[str] = None,
              accel: Optional[str] = None,
              accel_memory: int = 5,
              check_every: int = 1,
              unroll: int = 1,
              step_ratio: float = 1.0,
              adaptive: bool = False,
              relax: float = 1.0,
              chunk_iters: Optional[int] = None,
              checkpoint_on_fault: Optional[str] = None) -> SolverResult:
        """Run Chambolle-Pock from ``initial_state``; the options keep the
        JAX package's semantics (:meth:`raocp_tpu.Solver.solve`).

        :param alpha: overrides the 0.999/lambda_max(L'L) step rule
        :param warm_start: optional (primal, dual) (arrays or tensors, e.g.
            from :meth:`SolverResult.load_checkpoint`) to resume from
        :param log_every: print the last checked residuals every k steps
        :param profile_dir: wrap the solve in ``torch.profiler`` and write
            its Chrome trace to ``profile_dir/trace.json``
        :param accel: ``None`` (plain CP), ``"anderson"``, or
            ``"supermann"`` (aliases ``"broyden"``, ``"lbfgs"``); see
            :mod:`raocp_tpu_torch.accel`. Accelerated solves step with
            ``alpha`` itself and ignore ``step_ratio``, ``adaptive``,
            ``relax``, ``unroll`` and ``chunk_iters``.
        :param accel_memory: Anderson / Broyden history depth
        :param check_every: evaluate the residuals every k-th iteration
        :param unroll: CP steps per loop trip (must divide check_every)
        :param step_ratio: alpha1 = gamma * alpha, alpha2 = alpha / gamma
        :param adaptive: residual balancing of alpha1/alpha2 at each check
        :param relax: over-relaxation rho in (0, 2), or ``"auto"`` (1.8)
        :param chunk_iters: run the plain loop in chunks of this many
            iterations (each runs ``chunk_iters + 1`` steps, the loop's
            ``k + unroll < max_iters + 2`` rule) until convergence or
            ``max_iters``; see :func:`_chunked_loop` for the one retry
        :param checkpoint_on_fault: with ``chunk_iters``, where to write
            the last good iterate if the retry fails too
        """
        sp = self.__stacked
        relax = _resolve_relax(relax)
        x0_np = np.asarray(initial_state, dtype=np.float64).reshape(-1)
        if x0_np.shape != (sp.n,):
            raise ValueError(f"initial state must have {sp.n} entries")
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        if accel not in (None, "anderson", "supermann", "broyden", "lbfgs"):
            raise ValueError(f"unknown accel '{accel}'")
        stp = self.__part
        if stp is not None:
            if accel is not None and self.flat is None:
                raise ValueError(
                    "accelerated loops are not supported under the subtree "
                    "partition; use partition='flat'")
            sp = stp.sp
        x0 = torch.as_tensor(x0_np, dtype=sp.dtype, device=sp.device)
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()

        def conv(tree, cls):
            """Arrays or tensors -> tensors on the problem's device (no copy
            for tensors already there)."""
            return cls(*(torch.as_tensor(
                v if isinstance(v, torch.Tensor) else np.asarray(v),
                dtype=sp.dtype, device=sp.device) for v in tree))

        if warm_start is None:
            # the root is local row 0 (on every rank of the subtree
            # partition, on rank 0 of the flat one)
            z0 = sp.zero_primal()
            if sp.flat is None or sp.flat.rank == 0:
                z0.x[0] = x0         # reference cache_initial_state
            eta0 = sp.zero_dual()
        elif stp is not None:
            # warm starts are in the global layout, whatever the partition
            z0 = conv(stp.primal_to_local(warm_start[0]), Primal)
            eta0 = conv(stp.dual_to_local(warm_start[1]), Dual)
        else:
            z0 = conv(warm_start[0], Primal)
            eta0 = conv(warm_start[1], Dual)
        if stp is None:
            run_cp = functools.partial(_run_cp, sp)
            write_checkpoint = _write_iterate_npz
            trace = "trace.json"
        else:
            run_cp = stp.run_cp
            write_checkpoint = functools.partial(_write_global_checkpoint,
                                                 stp)
            trace = f"trace.rank{stp.rank}.json"
        if sp.device.type == "cuda":
            torch.cuda.synchronize(sp.device)
        tic = time.perf_counter()
        with _profiled(profile_dir, sp.device, trace):
            if accel is None and chunk_iters is not None:
                def run_chunk(zc, ec, iters_done):
                    return run_cp(
                        conv(zc, Primal), conv(ec, Dual), x0,
                        alpha * step_ratio, alpha / step_ratio, tol,
                        int(chunk_iters), check_every, unroll, adaptive,
                        relax, log_every, k0=iters_done)

                z, eta, iters, err, hist = _chunked_loop(
                    run_chunk, z0, eta0, tol, max_iters,
                    checkpoint_on_fault, write_checkpoint)
            elif accel is None:
                z, eta, iters, err, hist = run_cp(
                    z0, eta0, x0, alpha * step_ratio, alpha / step_ratio,
                    tol, max_iters, check_every, unroll, adaptive, relax,
                    log_every)
            else:
                from raocp_tpu_torch import accel as accel_mod
                run = (accel_mod.run_cp_anderson if accel == "anderson"
                       else accel_mod.run_cp_supermann)
                z, eta, iters, _evals, err, hist = run(
                    sp, z0, eta0, x0, alpha, tol, max_iters,
                    memory=accel_memory, check_every=check_every)
            if sp.device.type == "cuda":
                torch.cuda.synchronize(sp.device)
        toc = time.perf_counter()
        self.__result = SolverResult(
            status=0 if float(err.max()) <= tol else 1,
            num_iters=iters,
            xi=err,
            xi_history=hist[:, :3],
            delta_history=hist[:, 3:],
            alpha=float(alpha),
            solve_time=toc - tic,
            primal=_to_numpy(z) if stp is None else stp.primal_to_global(z),
            dual=_to_numpy(eta) if stp is None else stp.dual_to_global(eta),
        )
        return self.__result

    def chock(self, initial_state, max_iters: int = 10,
              tol: float = 1e-5) -> int:
        """Reference-parity entry point (``solver.py:97``): returns 0 on
        convergence, 1 otherwise; rich results stay on :attr:`result`."""
        return self.solve(initial_state, max_iters=max_iters, tol=tol).status

    def solve_batch(self, initial_states, max_iters: int = 10,
                    tol: float = 1e-5, alpha: Optional[float] = None,
                    check_every: int = 1, unroll: int = 1,
                    step_ratio: float = 1.0, adaptive: bool = False,
                    relax: float = 1.0) -> list:
        """Solve the same problem from a batch of initial states
        ([B, n]) in one loop whose every operation runs on all B lanes at
        once (:meth:`raocp_tpu.Solver.solve_batch`, which vmaps its loop):
        on the card a K1 apply of the batch is one launch set.

        Each lane keeps its own solve's semantics: it stops at its own
        iteration count with its own history, its steps rebalance on their
        own under ``adaptive`` (:func:`_run_cp_batch`), and a lane that
        starts from the single solve's initial state repeats that solve's
        iterations. Takes the plain-CP options of :meth:`solve` (no
        ``accel``, ``log_every``, ``warm_start`` or ``chunk_iters``).
        Returns one :class:`SolverResult` a lane, all with the batch's wall
        time. :attr:`result` is cleared, so a later :meth:`validate` or plot
        without a result raises; validate a lane with
        ``solver.validate(results[b])``.
        """
        if self.subtree is not None:
            raise ValueError("solve_batch is not supported under the "
                             "subtree partition; use partition='flat'")
        flat = self.flat
        sp = self.__stacked if flat is None else flat.sp
        x0s_np = np.asarray(initial_states, dtype=np.float64)
        if x0s_np.ndim != 2 or x0s_np.shape[1] != sp.n \
                or x0s_np.shape[0] == 0:
            raise ValueError(f"initial_states must be [batch, {sp.n}], got "
                             f"{x0s_np.shape}")
        batch = x0s_np.shape[0]
        relax = _resolve_relax(relax)
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        x0s = torch.as_tensor(x0s_np, dtype=sp.dtype, device=sp.device)
        z0 = Primal(*(leaf.expand((batch,) + tuple(leaf.shape)).clone()
                      for leaf in sp.zero_primal()))
        if flat is None or flat.rank == 0:
            z0.x[:, 0] = x0s         # reference cache_initial_state
        eta0 = Dual(*(leaf.expand((batch,) + tuple(leaf.shape)).clone()
                      for leaf in sp.zero_dual()))
        if sp.device.type == "cuda":
            torch.cuda.synchronize(sp.device)
        tic = time.perf_counter()
        # the flat partition's collectives are staged on the host: its
        # batch runs the host loop
        run = _run_cp_batch if flat is None else _run_cp_batch_host
        z, eta, iters, err, hist = run(
            sp, z0, eta0, x0s, alpha * step_ratio, alpha / step_ratio, tol,
            max_iters, check_every, unroll, adaptive, relax)
        if sp.device.type == "cuda":
            torch.cuda.synchronize(sp.device)
        toc = time.perf_counter()
        if flat is None:
            z, eta = _to_numpy(z), _to_numpy(eta)
        else:
            z, eta = flat.primal_to_global(z), flat.dual_to_global(eta)
        self.__result = None     # no single current result after a batch
        results = []
        for b in range(batch):
            nb = int(iters[b])
            results.append(SolverResult(
                status=0 if float(err[b].max()) <= tol else 1,
                num_iters=nb,
                xi=err[b],
                xi_history=hist[b, :nb, :3],
                delta_history=hist[b, :nb, 3:],
                alpha=float(alpha),
                solve_time=toc - tic,
                primal=Primal(*(v[b] for v in z)),
                dual=Dual(*(v[b] for v in eta)),
            ))
        return results

    # -- reporting (parity: reference solver.py:173-253) ---------------------

    def print_states(self) -> None:
        print("states =\n")
        for row in self.__result.primal.x:
            print(f"{row.reshape(-1, 1)}\n")

    def print_inputs(self) -> None:
        print("inputs =\n")
        for row in self.__result.primal.u:
            print(f"{row.reshape(-1, 1)}\n")

    def plot_residuals(self, filename: Optional[str] = None,
                       show: bool = True):
        from raocp_tpu_torch.utils.plots import plot_residuals
        return plot_residuals(self.__result, filename=filename, show=show)

    def plot_solution(self, filename: Optional[str] = None,
                      show: bool = True):
        from raocp_tpu_torch.utils.plots import plot_solution
        return plot_solution(self.__spec.tree, self.__result,
                             filename=filename, show=show)

    def save_residuals_tex(self, filename: str) -> None:
        """pgfplots export of the residual curves (reference writes
        '4-3-residuals.tex', ``solver.py:199``)."""
        from raocp_tpu_torch.utils.plots import save_residuals_tex
        save_residuals_tex(self.__result, filename)

    def save_solution_tex(self, filename: str) -> None:
        """pgfplots export of the trajectory fans (reference writes
        'python-solution.tex', ``solver.py:253``)."""
        from raocp_tpu_torch.utils.plots import save_solution_tex
        save_solution_tex(self.__spec.tree, self.__result, filename)

    def validate(self, result: Optional[SolverResult] = None) -> dict:
        """Host-side check of a solution (JAX ``solver.py:1010``), NumPy on
        the result. Returns max-norm violations of:

        * ``dynamics``: x_j - (A_j x_i + B_j u_i) over non-root nodes
        * ``kernel``: the risk-recursion kernel constraint M_i [y; tau; s]
        * ``constraints``: distance of [x; u] / x to each node's constraint
          set (0 when feasible), from the stacked tables and, on a sample
          of nodes, from the spec's own ``Constraint.violation``
        """
        res = result if result is not None else self.__result
        if res is None:
            raise RuntimeError("no solve result to validate")
        sp = self.__stacked
        spec = self.__spec
        tree = spec.tree
        x = np.asarray(res.primal.x)
        u = np.asarray(res.primal.u)
        y = np.asarray(res.primal.y)
        tau = np.asarray(res.primal.tau)
        s = np.asarray(res.primal.s)
        NL, N = sp.num_nonleaf, sp.num_nodes

        plan = self._validate_plan()
        modes_a, modes_b, w_idx = plan["dynamics"]
        anc = tree.ancestors
        dyn = 0.0
        for w in range(1, modes_a.shape[0]):
            nodes = np.nonzero(w_idx == w)[0]
            nodes = nodes[nodes >= 1]
            if nodes.size == 0:
                continue
            par = anc[nodes]
            pred = x[par] @ modes_a[w].T + u[par] @ modes_b[w].T
            dyn = max(dyn, float(np.abs(x[nodes] - pred).max()))

        # kernel: one batched matmul per distinct (E, F, child count)
        ker = 0.0
        ch_idx = tree.children_padded
        for E, F, c, nodes in plan["kernel_groups"]:
            nodes = np.asarray(nodes)
            eye, zc = np.eye(c), np.zeros((F.shape[1], c))
            M = np.vstack((np.hstack((E.T, -eye, -eye)),
                           np.hstack((F.T, zc, zc))))
            ch = ch_idx[nodes, :c]
            V = np.concatenate(
                [y[nodes, :E.shape[0]], tau[ch], s[ch]], axis=1)
            if V.size:
                ker = max(ker, float(np.abs(V @ M.T).max()))

        # constraints, from the stacked tables (Rectangle/Polyhedral row
        # residuals; Ball max-norm distance to the Euclidean projection)
        def table_violation(v, G, lo, hi, active, ball_c, ball_r):
            act = active > 0.0
            if not act.any():
                return 0.0
            img = v if G is None else v @ G.T
            rect = np.maximum(np.maximum(lo - img, img - hi), 0.0)
            rect = np.where(np.isfinite(rect), rect, 0.0).max(axis=1)
            diff = v - ball_c
            dist = np.linalg.norm(diff, axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                factor = np.where(
                    dist > ball_r, 1.0 - ball_r / np.maximum(dist, 1e-300),
                    0.0)
            ball = factor * np.abs(diff).max(axis=1)
            return float(np.maximum(rect, ball)[act].max())

        xu = np.concatenate([x[:NL], u[:NL]], axis=1)
        con = table_violation(
            xu, _host(sp.nl_G), _host(sp.nl_lo[:NL]), _host(sp.nl_hi[:NL]),
            _host(sp.nl_active[:NL]), _host(sp.nl_ball_c[:NL]),
            _host(sp.nl_ball_r[:NL]))
        LF = N - NL
        con = max(con, table_violation(
            x[NL:N], _host(sp.l_G), _host(sp.l_lo[:LF]),
            _host(sp.l_hi[:LF]), _host(sp.l_active[:LF]),
            _host(sp.l_ball_c[:LF]), _host(sp.l_ball_r[:LF])))

        # a deterministic node sample against the spec's per-node oracles,
        # independent of the stacked tables
        for i in plan["nl_sample"]:
            c = spec.nonleaf_constraint_at_node(int(i))
            if c.is_active:
                con = max(con, float(c.violation(xu[i])))
        for i in plan["lf_sample"]:
            c = spec.leaf_constraint_at_node(int(NL + i))
            if c.is_active:
                con = max(con, float(c.violation(x[NL + i])))

        return {"dynamics": dyn, "kernel": ker, "constraints": con}

    def _validate_plan(self) -> dict:
        """The O(num_nodes) host setup of :meth:`validate` (dynamics mode
        interning, kernel groups, constraint samples), once per Solver."""
        if self.__validate_plan is not None:
            return self.__validate_plan
        sp = self.__stacked
        spec = self.__spec
        tree = spec.tree
        NL, N = sp.num_nonleaf, sp.num_nodes
        groups: dict = {}
        for i in range(NL):
            risk = spec.risk_at_node(i)
            E, F = risk.matrix_e, risk.matrix_f
            c = int(tree.child_count[i])
            key = (E.shape, E.tobytes(), F.shape, F.tobytes(), c)
            groups.setdefault(key, (E, F, c, []))[3].append(i)
        # <= 64 evenly spaced nodes per class
        nl_sample = np.unique(np.linspace(0, NL - 1, min(NL, 64),
                                          dtype=np.int64)) if NL else []
        lf = N - NL
        lf_sample = np.unique(np.linspace(0, lf - 1, min(lf, 64),
                                          dtype=np.int64)) if lf else []
        self.__validate_plan = {
            "dynamics": _dedup_dynamics(spec, sp.n, sp.m),
            "kernel_groups": list(groups.values()),
            "nl_sample": nl_sample,
            "lf_sample": lf_sample,
        }
        return self.__validate_plan
