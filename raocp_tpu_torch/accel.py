"""Accelerated fixed-point iterations for the Chambolle-Pock map (counterpart
of :mod:`raocp_tpu.accel`).

The CP iteration is a (quasi-)nonexpansive fixed-point map T on the joint
primal-dual vector w = (z, eta). Two globalised accelerators of that fixed
point, both falling back to the plain step so that they inherit the
convergence of plain CP:

* :func:`run_cp_anderson` — safeguarded Anderson acceleration (type II)
* :func:`run_cp_supermann` — SuperMann-style globalisation with
  limited-memory Broyden quasi-Newton directions on the residual map

The JAX package's layout carries over:

* **Extended vectors.** Every point is W = (z, eta, Lz, L'eta), held here
  as one flat, contiguous 1-D buffer whose 32 leaves are views
  (:class:`_Layout`, one per problem: each leaf's start aligned to 256
  bytes, the (z, eta) leaves first, the padding between leaves 0), so
  every combination of extended vectors is one operation on the whole
  buffer. L and L' are linear, so the image components of any affine
  combination of consistent extended vectors are consistent images: one T
  evaluation (:func:`_t_ext`, which is ``solver._cp_step`` on the leaf
  views, so ``prox_f`` and K1 on eligible trees) costs the plain step's
  two operator applies. Norms and inner products read only the (z, eta)
  prefix.
* **Circular histories.** Each history is one ``[memory, size]`` buffer,
  preallocated once and written in place at ``slot`` (never rolled).
  Anderson's Gram matrix is kept one row and column at a time; the
  ``[memory, memory]`` normal equations go to ``torch.linalg.solve_ex``
  (:func:`_solve`: no check of its ``info``, which would read the
  device).

As in the JAX package, each loop keeps its state, its branch decisions and
its counters on the device (:func:`_device_loop`, the jitted
``while_loop``): every iteration runs under a guard on the device's
``running`` flag, ``lax.cond`` is :func:`raocp_tpu_torch.ops.cond.branch`
(the bodies write into fixed buffers), and the loop runs a period of
iterations at a time (:class:`raocp_tpu_torch.ops.cond.Periods`). On a
single device on a card a period is one replay of a CUDA graph whose
branches are conditional nodes, captured at a problem's first solve and
cached per problem and options (``_LOOPS``); the host reads one flag a
period, and the T evaluations, the iterations and the final residuals
once at the end. Anywhere else the same periods run eagerly
(:func:`raocp_tpu_torch.ops.cond.captures`): on the CPU, and on the flat
partition, whose norms and inner products sum over the ranks with a gloo
all-reduce (:func:`_allsum`) that a graph cannot capture; each branch then
reads an all-reduced predicate, so every rank takes the same branches.
SuperMann's safeguard scalars are float64 (``_SAFEGUARD``).

:data:`LOOP_COUNTS` counts what the loops ran and their reads of the
host (:func:`_read`), and times them.
"""

import collections
import contextlib
import math
import types
import typing
import weakref

import numpy as np
import torch
import torch.distributed as dist

from raocp_tpu_torch import solver as solver_mod
from raocp_tpu_torch.core.stacked import StackedProblem
from raocp_tpu_torch.core.variables import Dual, Primal
from raocp_tpu_torch.ops import cond as cond_mod
from raocp_tpu_torch.ops import prox as prox_mod
from raocp_tpu_torch.ops import sweep as sweep_mod
from raocp_tpu_torch.ops.cond import Periods, branch, capturing
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import half_shift_dual
from raocp_tpu_torch.parallel.sharding import all_reduce
from raocp_tpu_torch.solver import _cp_residuals, _cp_step

__all__ = ["run_cp_anderson", "run_cp_supermann", "LOOP_COUNTS",
           "BODY_RUNS"]

# What the device loops ran, summed since import (read deltas around a
# run): periods (eager or replayed), of them graph replays; captures and
# their seconds (the eager first period, the warm-up capture and the
# graph); the loops' host reads (a flag a period, the final counts and
# history; the capture's eager branches); T evaluations and iterations
# (the device's counts), and of the T evaluations those that replays ran.
# A replayed T evaluation is a prox_f call that Python made once, at
# capture (``scripts.bench_configs.counted_calls`` adds them to its count);
# the device loop takes their number from its bodies' counts (below), and
# K1's replayed launches from its own count of T evaluations, so the two
# are independent witnesses of what the replays ran. Host seconds of the
# device loops' spans (``ops.cond.span``): each drive
# (``raocp.loop.drive``) and each replay in it (``raocp.loop.launch``);
# device seconds from the card's clock (``ops.cond.Flags``): the replayed
# periods whose flag was read, their number, and the card's gaps between
# two of them in one call.
LOOP_COUNTS = dict(periods=0, replays=0, captures=0, capture_seconds=0.0,
                   host_reads=0, t_evals=0, iterations=0,
                   replayed_t_evals=0, drive_seconds=0.0,
                   launch_seconds=0.0, period_device_seconds=0.0,
                   gap_device_seconds=0.0, timed_periods=0)

# The bodies each loop ran, summed since import: (kind, body) -> runs,
# counted on the device (an int64 counter a body, never reset, that the
# body itself adds to, read with the final counts); one run gives the same
# counts replayed or eager, so a body that a replay ran untaken shows
# there. T evaluations:
# Anderson's are 1 + iteration + fallback, SuperMann's 1 + attempt + blind
# + plain.
BODIES = {"anderson": ("iteration", "accepted", "fallback"),
          "supermann": ("iteration", "attempt", "blind", "accept", "plain")}
BODY_RUNS = collections.Counter()

# guarded iterations in a period of a loop that checks every iteration
PERIOD_CHECK_EVERY_1 = 16

# the dtype of SuperMann's safeguard scalars (eta_safe, r_safe, eps and the
# norms they meet), whatever the problem's
_SAFEGUARD = torch.float64

_NP = len(Primal._fields)          # 5 primal leaves
_ND = len(Dual._fields)            # 11 dual leaves
_TRUE = _NP + _ND                  # the (z, eta) leaves of an extended W

# where a leaf of an extended vector may start in its flat buffer: the dual
# kernel takes vector loads only from aligned addresses
_ALIGN_BYTES = 256


class _Layout(typing.NamedTuple):
    """An extended vector's 32 leaves in one flat buffer: each leaf's
    offset and shape, the length of the (z, eta) prefix and the buffer's;
    the padding between leaves stays 0 (every flat operation maps zeros to
    zeros, and nothing writes there)."""
    offsets: tuple
    shapes: tuple
    n_true: int
    size: int


# each problem's layout: id(sp) -> _Layout, gone with the problem
_LAYOUTS = {}

# T evaluations run eagerly (not captured), summed since import
_EAGER_T = 0

# each problem's loops that capture: (id(sp), kind) -> (key, loop);
# a loop holds no reference to its problem (it comes with each call), so
# the entry goes with the problem
_LOOPS = {}


def _read(t):
    """One device-to-host read (a sync), counted in ``LOOP_COUNTS``."""
    LOOP_COUNTS["host_reads"] += 1
    return t.cpu().numpy()


def _layout(sp) -> _Layout:
    """The extended vectors' layout on ``sp`` (set by :func:`_start`)."""
    return _LAYOUTS[id(sp)]


def _set_layout(sp, leaves) -> _Layout:
    """Lay the 32 ``leaves`` of an extended vector out in one flat buffer:
    each leaf's start rounded up to ``_ALIGN_BYTES``, (z, eta) first, and
    remember the layout for ``sp`` (it goes with the problem)."""
    step = max(1, _ALIGN_BYTES // leaves[0].element_size())
    offsets, end = [], 0
    for v in leaves:
        offsets.append(end)
        end += -(-v.numel() // step) * step
    lay = _Layout(tuple(offsets), tuple(tuple(v.shape) for v in leaves),
                  offsets[_TRUE], end)
    if id(sp) not in _LAYOUTS:
        weakref.finalize(sp, _LAYOUTS.pop, id(sp), None)
    _LAYOUTS[id(sp)] = lay
    return lay


def _views(lay, W):
    """The 32 leaves of the flat extended vector ``W``, as contiguous
    views."""
    return [W[o:o + math.prod(s)].view(s)
            for o, s in zip(lay.offsets, lay.shapes)]


def _split(sp, W):
    v = _views(_layout(sp), W)
    a, b, c = _NP, _NP + _ND, _NP + 2 * _ND
    return Primal(*v[:a]), Dual(*v[a:b]), Dual(*v[b:c]), Primal(*v[c:])


def _pack(sp, leaves, out=None):
    """The 32 ``leaves`` copied into the flat buffer ``out`` (a new one,
    padding 0, when None): one multi-tensor copy of the leaves whose strides
    are the layout's, one copy for each other (a column slice)."""
    lay = _layout(sp)
    if out is None:
        out = leaves[0].new_zeros(lay.size)
    views = _views(lay, out)
    same = [i for i, (d, s) in enumerate(zip(views, leaves))
            if d.stride() == s.stride()]
    torch._foreach_copy_([views[i] for i in same], [leaves[i] for i in same])
    for i in sorted(set(range(len(leaves))) - set(same)):
        views[i].copy_(leaves[i])
    return out


def _t_ext(sp, W, alpha, x0, shift, out=None):
    """One CP step on an extended point: T(W), extended, written into
    ``out`` (see :func:`_pack`). Two operator applies; the images of the
    input ride in W."""
    global _EAGER_T
    _EAGER_T += not capturing(W)
    z, eta, Lz, Lt = _split(sp, W)
    zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, alpha, alpha, x0, shift)
    return _pack(sp, (*zn, *en, *Lzn, *Ltn), out)


def _allsum(sp, t):
    """``t`` summed over the ranks of the flat partition (itself on one
    device)."""
    if sp.flat is None:
        return t
    return all_reduce(t.reshape(-1).contiguous(), dist.ReduceOp.SUM,
                      sp.spmd_group).reshape(t.shape)


def _sq(sp, W):
    """<W, W> over the (z, eta) prefix (a 0-d tensor)."""
    v = W[:_layout(sp).n_true]
    return _allsum(sp, torch.vdot(v, v))


def _norm(sp, W):
    """Euclidean norm of the (z, eta) prefix (a 0-d tensor)."""
    return torch.sqrt(_sq(sp, W))


def _solve(Gm, b):
    """Anderson's normal equations ``Gm gamma = b`` (LU, as
    ``torch.linalg.solve``), without the check of the factorisation's
    ``info`` that would read the device: Gm is the masked Gram matrix plus
    ``reg`` on its diagonal, symmetric positive definite."""
    return torch.linalg.solve_ex(Gm, b, check_errors=False)[0]


def _h_zeros(template, memory):
    """A history: ``memory`` rows shaped as the flat ``template``."""
    return template.new_zeros((memory, template.numel()))


def _h_dot(sp, hist, vec):
    """[memory] inner products <row_m, v> over the (z, eta) prefix."""
    n = _layout(sp).n_true
    return _allsum(sp, hist[:, :n] @ vec[:n])


def _h_combo(hist, gamma):
    """sum_m gamma[m] row_m over the whole row (images included)."""
    return gamma @ hist


def _start(sp, z0, eta0, alpha, x0):
    """The extended start point, the plain-step constants and T(W0)."""
    dt, dev = sp.dtype, sp.device
    a = torch.as_tensor(alpha, dtype=dt, device=dev)
    shift = half_shift_dual(sp)
    z0, eta0 = Primal(*z0), Dual(*eta0)
    leaves = (*z0, *eta0, *ell(sp, z0), *ell_t(sp, eta0))
    _set_layout(sp, leaves)
    W0 = _pack(sp, leaves)
    return a, shift, W0, _t_ext(sp, W0, a, x0, shift)


def _residuals(sp, W, T, alpha):
    """The [xi_0..2] and [delta_0..2] stopping residuals of W -> T(W) (one
    extra operator apply), on the device."""
    z, eta, Lz, Lt = _split(sp, W)
    zn, en, Lzn, Ltn = _split(sp, T)
    return _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha, alpha)


# -- the device loops (JAX: the jitted while_loops) --------------------------

def _loop_state(sp, kind, W0, memory, capacity, scalars):
    """The buffers of one accelerated loop: the iterate W and residual R,
    the step's result (Wn, Rn), err/derr at the last check, the history
    rows, the counters k and evals (int64), the running flag, the
    constants a solve loads (alpha, x0, tol as float64, the cap), the
    loop's own ``scalars`` (name -> dtype, 0-d) and its bodies' run
    counters (``BODIES[kind]``, never reset; ``seen``: their values at the
    last read)."""
    dt, dev = sp.dtype, sp.device
    names = BODIES[kind]
    L = types.SimpleNamespace(
        kind=kind, body=dict(zip(names, range(len(names)))),
        bodies=torch.zeros(len(names), dtype=torch.int64, device=dev),
        seen=np.zeros(len(names), dtype=np.int64),
        W=torch.zeros_like(W0), R=torch.zeros_like(W0),
        Wn=torch.zeros_like(W0), Rn=torch.zeros_like(W0),
        err=torch.empty(3, dtype=dt, device=dev),
        derr=torch.empty(3, dtype=dt, device=dev),
        hist=torch.empty((capacity, 6), dtype=dt, device=dev),
        k=torch.zeros((), dtype=torch.int64, device=dev),
        evals=torch.zeros((), dtype=torch.int64, device=dev),
        running=torch.ones((), dtype=torch.bool, device=dev),
        a=torch.empty((), dtype=dt, device=dev),
        x0=torch.empty(sp.n, dtype=dt, device=dev),
        tol=torch.zeros((), dtype=torch.float64, device=dev),
        limit=torch.zeros((), dtype=torch.int64, device=dev),
        shift=half_shift_dual(sp), memory=memory)
    for name, dtype in scalars.items():
        setattr(L, name, torch.zeros((), dtype=dtype, device=dev))
    return L


def _load(L, W0, R0, err, derr, alpha, x0, tol, max_iters, check_every):
    """Start a solve: the state from the start point, the history's first
    ``max_iters + 1`` rows set to 0 (``check_every`` 1) or NaN."""
    L.W.copy_(W0)
    L.R.copy_(R0)
    L.err.copy_(err)
    L.derr.copy_(derr)
    L.hist[:max_iters + 1].fill_(0.0 if check_every == 1 else math.nan)
    L.k.zero_()
    L.evals.fill_(1)
    L.running.fill_(True)
    L.a.fill_(float(alpha))
    L.x0.copy_(x0)
    L.tol.fill_(float(tol))
    L.limit.fill_(max_iters + 1)


def _check(sp, L, W, T):
    """The residual check of the step W -> T(W): err/derr and the history
    row at k (``index_copy_`` at the device's count)."""
    err, derr = _residuals(sp, W, T, L.a)
    L.err.copy_(err)
    L.derr.copy_(derr)
    L.hist.index_copy_(0, L.k.reshape(1), torch.cat([err, derr])[None])


def _ran(L, body):
    """Count a run of ``body`` on the device (inside the body)."""
    L.bodies[L.body[body]].add_(1)


def _advance(L):
    """W <- Wn, R <- Rn, k += 1, and the loop's condition after it: the
    last checked residual above tol (compared in float64) and
    k < max_iters + 1."""
    L.W.copy_(L.Wn)
    L.R.copy_(L.Rn)
    L.k.add_(1)
    L.running.copy_((L.err.double().amax() > L.tol) & (L.k < L.limit))


def _anderson_iteration(sp, L, checked, theta):
    """One iteration of :func:`run_cp_anderson`'s loop on the device state
    ``L``, in place, under the guard of ``L.running`` (JAX
    ``accel.py:190``): the candidate and its T evaluation, written straight
    into (Wn, Rn), then the accepted body or the fallback (its own T
    evaluation, over them); the check when ``checked``; the slot's history
    rows and Gram row and column."""
    dt = sp.dtype

    def body():
        _ran(L, "iteration")
        valid = (L.slots < L.pushes).to(dt)
        Gm = L.G * (valid[:, None] * valid[None, :]) + L.reg_eye
        b = _h_dot(sp, L.dR, L.R) * valid
        gamma = _solve(Gm, b) * valid
        torch.sub(L.W + L.R, _h_combo(L.dW, gamma) + _h_combo(L.dR, gamma),
                  out=L.Wn)
        _t_ext(sp, L.Wn, L.a, L.x0, L.shift, out=L.Rn)
        L.Rn.sub_(L.Wn)
        accept = (L.pushes > 0) & (_norm(sp, L.Rn)
                                   <= theta * _norm(sp, L.R))

        def accepted():
            _ran(L, "accepted")
            L.evals.add_(1)

        def fallback():
            # the plain step w+ = T(w) = w + r; one more T evaluation
            # refreshes the residual there
            _ran(L, "fallback")
            torch.add(L.W, L.R, out=L.Wn)
            _t_ext(sp, L.Wn, L.a, L.x0, L.shift, out=L.Rn)
            L.Rn.sub_(L.Wn)
            L.evals.add_(2)

        branch(accept, accepted, fallback)
        if checked:
            _check(sp, L, L.Wn, L.Wn + L.Rn)
        slot = (L.pushes % L.memory).reshape(1)
        row = L.Rn - L.R
        L.dR.index_copy_(0, slot, row[None])
        L.dW.index_copy_(0, slot, (L.Wn - L.W)[None])
        g_row = _h_dot(sp, L.dR, row)        # the slot's row + column
        L.G.index_copy_(0, slot, g_row[None, :])
        L.G.index_copy_(1, slot, g_row[:, None])
        L.pushes.add_(1)
        _advance(L)

    branch(L.running, body)


def _supermann_iteration(sp, L, checked, ls_max, c0, c1, q_eps, beta):
    """One iteration of :func:`run_cp_supermann`'s loop on the device
    state ``L``, in place, under the guard of ``L.running`` (JAX
    ``accel.py:352``). K0 (blind), the line search's ``ls_max`` tries
    (each under the guard "admitted and not yet accepted", at the constant
    tau = beta^j of try j) and the plain fallback are bodies of their own,
    each writing (Wn, Rn) in place; then the Broyden push and the check.
    The safeguard scalars (eta_safe, r_safe, eps, the norms they meet) are
    ``_SAFEGUARD`` (float64)."""
    dt = sp.dtype

    def apply_h(V):
        w = _h_dot(sp, L.Y, V) * L.valid
        return V + _h_combo(L.U, w)

    def step_to(W_new):
        # (Wn, Rn) <- (W_new, W_new - T(W_new)), W_new already in Wn
        _t_ext(sp, W_new, L.a, L.x0, L.shift, out=L.Rn)
        torch.sub(L.Wn, L.Rn, out=L.Rn)

    def body():
        _ran(L, "iteration")
        norm_r = _norm(sp, L.R).to(_SAFEGUARD)
        d = -apply_h(L.R)
        blind = norm_r <= c0 * L.eta_safe
        admit = ~blind & (norm_r <= L.r_safe)
        L.ok.fill_(False)
        L.tries.zero_()
        tau = 1.0
        for _ in range(ls_max):
            def attempt(tau=tau):
                # backtrack: the candidate w + tau d and its residual
                _ran(L, "attempt")
                step_to(torch.add(L.W, tau * d, out=L.Wn))
                norm_c = _norm(sp, L.Rn).to(_SAFEGUARD)
                L.norm_c.copy_(norm_c)
                L.ok.copy_(norm_c <= c1 * norm_r)
                L.tries.add_(1)

            branch(admit & ~L.ok, attempt)
            tau *= beta
        accepted = admit & L.ok

        def blind_step():
            # K0: accept w + d without a test; eta_safe tightens
            _ran(L, "blind")
            step_to(torch.add(L.W, d, out=L.Wn))
            L.eta_safe.copy_(norm_r)
            L.evals.add_(1)

        def accept_step():
            # K1: the line search's candidate is already in (Wn, Rn)
            _ran(L, "accept")
            L.r_safe.copy_(L.norm_c + L.eps)
            L.evals.add_(L.tries)

        def plain_step():
            _ran(L, "plain")
            step_to(torch.sub(L.W, L.R, out=L.Wn))
            L.evals.add_(L.tries + 1)

        branch(blind, blind_step)
        branch(accepted, accept_step)
        branch(~blind & ~accepted, plain_step)

        # Broyden push: u = (s - H y) / (y.y); degenerate pairs are masked
        s = L.Wn - L.W
        y = L.Rn - L.R
        yy = _sq(sp, y)
        good = yy > 1e-30
        denom = torch.where(good, yy, torch.ones_like(yy))
        gz = good.to(dt)
        u = s.sub_(apply_h(y)).div_(denom).mul_(gz)
        slot = L.slot.reshape(1)
        L.U.index_copy_(0, slot, u[None])
        L.Y.index_copy_(0, slot, y[None])
        L.valid.index_copy_(0, slot, gz.reshape(1))
        L.slot.copy_((L.slot + 1) % L.memory)
        if checked:
            _check(sp, L, L.Wn, L.Wn - L.Rn)
        L.eps.mul_(q_eps)
        _advance(L)

    branch(L.running, body)


def _loop_for(sp, kind, memory, period, check_every, options, capacity,
              make):
    """The problem's device loop of ``kind`` for these options: where the
    loop captures (:func:`~raocp_tpu_torch.ops.cond.captures`) the cached
    one (kept while the key holds and its history holds ``capacity`` rows,
    so a solver's later solves replay its graph), else a new one
    (``make()``). The key is what changes the captured program: the
    options, the period and the dynamics projection's dispatch (K1, the
    stage path, or a patched sweep)."""
    if not cond_mod.captures(sp):
        return make()
    key = (memory, period, check_every, options,
           sweep_mod.sweep_eligible(sp), prox_mod.project_dynamics_sweep)
    slot = (id(sp), kind)
    cached = _LOOPS.get(slot)
    if cached is not None and cached[0] == key \
            and cached[1].hist.shape[0] >= capacity:
        return cached[1]
    if slot not in _LOOPS:
        weakref.finalize(sp, _LOOPS.pop, slot, None)
    _LOOPS[slot] = None             # drop the old loop's memory first
    loop = make()
    _LOOPS[slot] = (key, loop)
    return loop


def _device_loop(sp, kind, z0, eta0, x0, alpha, tol, max_iters, memory,
                 check_every, options, iteration, scalars, init):
    """The accelerated loop ``kind`` with its state on the device: a period
    is ``check_every`` guarded iterations, its last a check (at
    ``check_every=1`` every iteration checks and a period is
    ``PERIOD_CHECK_EVERY_1`` of them), the cap and the tolerance stop it in
    mid-period, and the host reads one flag a period
    (:class:`~raocp_tpu_torch.ops.cond.Periods`; where it captures one
    period is enqueued ahead of the flag). ``iteration(sp, L, checked)`` is
    one guarded iteration (it must hold no reference to ``sp``: a loop
    that captures is cached), ``scalars`` the loop's own 0-d buffers and
    ``init(L, W0, R0)`` sets what a solve starts from. Returns (z, eta,
    iters, t_evals, err NumPy [3], hist NumPy [iters, 6])."""
    if check_every < 1:
        raise ValueError("check_every must be at least 1")
    period = PERIOD_CHECK_EVERY_1 if check_every == 1 else check_every
    capacity = max(1024, 1 << max_iters.bit_length())
    cached = cond_mod.captures(sp)
    eager_t = _EAGER_T
    before = dict(LOOP_COUNTS)
    with (torch.cuda.device(sp.device) if sp.device.type == "cuda"
          else contextlib.nullcontext()):
        a, shift, W0, T0 = _start(sp, z0, eta0, alpha, x0)
        R0 = T0 - W0 if kind == "anderson" else W0 - T0
        err, derr = _residuals(sp, W0, T0, a)

        def make():
            L = _loop_state(sp, kind, W0, memory, capacity, scalars)
            checks = [check_every == 1 or i == period - 1
                      for i in range(period)]

            def run_period(sp, L):
                for checked in checks:
                    iteration(sp, L, checked)

            L.periods = Periods(sp.device, run_period, L.running, cached,
                                LOOP_COUNTS)
            return L

        L = _loop_for(sp, kind, memory, period, check_every, options,
                      capacity, make)
        _load(L, W0, R0, err, derr, alpha, x0, tol, max_iters, check_every)
        init(L, W0, R0)
        with cond_mod.span("raocp.loop.drive", LOOP_COUNTS,
                           "drive_seconds"):
            L.periods.run(-(-(max_iters + 1) // period),
                          solver_mod._lookahead(sp), sp, L)
        out = _read(torch.cat([torch.stack([L.k, L.evals]).double(),
                               L.bodies.double(), L.err.double()]))
        iters, evals = int(out[0]), int(out[1])
        seen = out[2:2 + len(L.seen)].astype(np.int64)
        ran = dict(zip(BODIES[kind], (seen - L.seen).tolist()))
        L.seen = seen
        hist = _read(L.hist[:iters]).astype(np.float64)
        z, eta, _, _ = _split(sp, L.W)
        if cached:                   # the buffers stay with the cached loop
            z, eta = (type(t)(*(v.clone() for v in t)) for t in (z, eta))
    eager = _EAGER_T - eager_t
    BODY_RUNS.update({(kind, name): n for name, n in ran.items()})
    LOOP_COUNTS["t_evals"] += evals
    LOOP_COUNTS["iterations"] += iters
    # the T evaluations that replays ran, from the bodies' counts
    LOOP_COUNTS["replayed_t_evals"] += _body_t_evals(kind, ran) - eager
    # K1's launches from the loop's own count: every T evaluation calls
    # prox_f once, and prox_f K1 once on its path
    sweep_mod.LAUNCHES += (evals - eager) * (L.periods.recorded > 0)
    replays = LOOP_COUNTS["replays"] - before["replays"]
    if replays:
        # a replay runs the set kernels of its period's guards, and those
        # of the branches inside each iteration that ran (the capture's
        # eager first period ran the first iterations)
        outer, inner = L.periods.nodes
        eager_iters = min(period, iters) if LOOP_COUNTS["captures"] \
            > before["captures"] else 0
        cond_mod.LAUNCHES += replays * outer \
            + (ran["iteration"] - eager_iters) * inner // period
    return z, eta, iters, evals, out[2 + len(L.seen):], hist


def _body_t_evals(kind, ran) -> int:
    """The T evaluations that the bodies ``ran`` (body -> runs) made, the
    start's included."""
    if kind == "anderson":
        return 1 + ran["iteration"] + ran["fallback"]
    return 1 + ran["attempt"] + ran["blind"] + ran["plain"]


def run_cp_anderson(sp: StackedProblem, z0, eta0, x0, alpha, tol,
                    max_iters: int, memory: int = 5, theta: float = 1.0,
                    reg: float = 1e-10, check_every: int = 1):
    """Safeguarded Anderson-accelerated CP (JAX ``accel.py:144``). Returns
    (z, eta, iters, t_evals, err, hist): z/eta as tensors, err NumPy [3],
    hist NumPy [iters, 6] (NaN rows between strided checks).

    Accept the Anderson candidate iff ||r_cand|| <= theta ||r||, else take
    the plain step w+ = T(w) and evaluate T once more there. The loop runs
    on the device (:func:`_device_loop`).
    """
    dt, dev = sp.dtype, sp.device
    scalars = dict(pushes=torch.int64)

    def init(L, W0, R0):
        if not hasattr(L, "dW"):
            L.dW = _h_zeros(W0, memory)
            L.dR = _h_zeros(W0, memory)
            L.G = torch.zeros((memory, memory), dtype=dt, device=dev)
            L.reg_eye = reg * torch.eye(memory, dtype=dt, device=dev)
            L.slots = torch.arange(memory, device=dev)
        for h in (L.dW, L.dR, L.G):
            h.zero_()
        L.pushes.zero_()

    return _device_loop(
        sp, "anderson", z0, eta0, x0, alpha, tol, max_iters, memory,
        check_every, (theta, reg),
        lambda sp, L, checked: _anderson_iteration(sp, L, checked, theta),
        scalars, init)


def run_cp_supermann(sp: StackedProblem, z0, eta0, x0, alpha, tol,
                     max_iters: int, memory: int = 5, ls_max: int = 1,
                     c0: float = 0.99, c1: float = 1.0, q_eps: float = 0.95,
                     beta: float = 0.5, check_every: int = 1):
    """SuperMann-style globalised quasi-Newton acceleration of the CP fixed
    point with limited-memory (type-I) Broyden directions (JAX
    ``accel.py:254``): H = I + sum_i u_i y_i' on the residual map
    R(w) = w - T(w).

    * **K0 (blind)**: while ``|R w| <= c0 * eta_safe``, take w + d.
    * **K1 (educated)**: if ``|R w| <= r_safe``, backtrack tau (at most
      ``ls_max`` tries) until ``|R(w + tau d)| <= c1 |R w|``.
    * **Fallback**: the plain CP step w+ = T(w).

    Returns (z, eta, iters, t_evals, err, hist) as
    :func:`run_cp_anderson` does. The loop runs on the device
    (:func:`_device_loop`).
    """
    dt, dev = sp.dtype, sp.device
    f64 = _SAFEGUARD
    scalars = dict(eta_safe=f64, r_safe=f64, eps=f64, norm_c=f64,
                   ok=torch.bool, tries=torch.int64, slot=torch.int64)

    def init(L, W0, R0):
        if not hasattr(L, "U"):
            L.U = _h_zeros(W0, memory)      # Broyden vectors u_i
            L.Y = _h_zeros(W0, memory)      # y_i = r_{i+1} - r_i
            L.valid = torch.zeros((memory,), dtype=dt, device=dev)
        for h in (L.U, L.Y, L.valid):
            h.zero_()
        nr0 = _norm(sp, R0).to(_SAFEGUARD)
        for v in (L.eta_safe, L.r_safe, L.eps):
            v.copy_(nr0)
        L.slot.zero_()

    return _device_loop(
        sp, "supermann", z0, eta0, x0, alpha, tol, max_iters, memory,
        check_every, (ls_max, c0, c1, q_eps, beta),
        lambda sp, L, checked: _supermann_iteration(sp, L, checked, ls_max,
                                                    c0, c1, q_eps, beta),
        scalars, init)
