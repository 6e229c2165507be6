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
  as one flat tuple of the 32 leaves. L and L' are linear, so the image
  components of any affine combination of consistent extended vectors are
  consistent images: one T evaluation (:func:`_t_ext`, which is
  ``solver._cp_step``, so ``prox_f`` and K1 on eligible trees) costs the
  plain step's two operator applies. Norms and inner products read only
  the (z, eta) leaves.
* **Circular histories.** Each history is a tuple of tensors with a leading
  ``[memory]`` axis, preallocated once and written in place at ``slot``
  (never rolled). Anderson's Gram matrix is kept one row and column at a
  time; the ``[memory, memory]`` normal equations are ``torch.linalg.solve``.

What differs from the JAX package: ``lax.cond`` / ``lax.while_loop`` become
Python branches on a 0-d tensor, and a branch needs its condition on the
host. That is one device-to-host read per accepted iteration (Anderson's
safeguard; SuperMann's residual norm), plus one per SuperMann line-search
try, plus the read of each residual check as in the plain loop. Each read
waits for the device to drain its queue. Every read goes through
:func:`_read`, which counts it in :data:`HOST_READS` and marks it as a
``raocp.accel.host_read`` span in a ``torch.profiler`` trace.
"""

import numpy as np
import torch

from raocp_tpu_torch.core.stacked import StackedProblem
from raocp_tpu_torch.core.variables import Dual, Primal
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import half_shift_dual
from raocp_tpu_torch.solver import _cp_residuals, _cp_step

__all__ = ["run_cp_anderson", "run_cp_supermann", "HOST_READS"]

HOST_READS = 0

_NP = len(Primal._fields)          # 5 primal leaves
_ND = len(Dual._fields)            # 11 dual leaves
_TRUE = _NP + _ND                  # the (z, eta) leaves of an extended W


def _read(t):
    """One device-to-host read (a sync), counted and marked in traces."""
    global HOST_READS
    HOST_READS += 1
    with torch.profiler.record_function("raocp.accel.host_read"):
        return t.cpu().numpy()


def _split(W):
    a, b, c = _NP, _NP + _ND, _NP + 2 * _ND
    return Primal(*W[:a]), Dual(*W[a:b]), Dual(*W[b:c]), Primal(*W[c:])


def _t_ext(sp, W, alpha, x0, shift):
    """One CP step on an extended point: T(W), extended. Two operator
    applies; the images of the input ride in W."""
    z, eta, Lz, Lt = _split(W)
    zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, alpha, alpha, x0, shift)
    return (*zn, *en, *Lzn, *Ltn)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _norm(W):
    """Euclidean norm of the (z, eta) leaves (a 0-d tensor)."""
    return torch.sqrt(torch.stack([torch.vdot(v.reshape(-1), v.reshape(-1))
                                   for v in W[:_TRUE]]).sum())


def _h_zeros(template, memory):
    return tuple(torch.zeros((memory,) + tuple(v.shape), dtype=v.dtype,
                             device=v.device) for v in template)


def _h_set(hist, slot, row):
    for h, r in zip(hist, row):
        h[slot].copy_(r)


def _h_dot(hist, vec):
    """[memory] inner products <row_m, v> over the (z, eta) leaves."""
    return torch.stack([h.reshape(h.shape[0], -1) @ v.reshape(-1)
                        for h, v in zip(hist[:_TRUE], vec[:_TRUE])]).sum(0)


def _h_combo(hist, gamma):
    """sum_m gamma[m] row_m over every leaf (images included)."""
    return tuple(torch.tensordot(gamma, h, dims=1) for h in hist)


def _start(sp, z0, eta0, alpha, x0):
    """The extended start point, the plain-step constants and T(W0)."""
    dt, dev = sp.dtype, sp.device
    a = torch.as_tensor(alpha, dtype=dt, device=dev)
    shift = half_shift_dual(sp)
    z0, eta0 = Primal(*z0), Dual(*eta0)
    W0 = (*z0, *eta0, *ell(sp, z0), *ell_t(sp, eta0))
    return a, shift, W0, _t_ext(sp, W0, a, x0, shift)


def _residual_row(sp, W, T, alpha):
    """The [xi_0..2, delta_0..2] stopping residuals of W -> T(W) as a NumPy
    row (one extra operator apply, one host read)."""
    z, eta, Lz, Lt = _split(W)
    zn, en, Lzn, Ltn = _split(T)
    err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn,
                              alpha, alpha)
    return _read(torch.cat([err, derr]))


def _history(max_iters, check_every):
    return np.full((max_iters + 1, 6), 0.0 if check_every == 1 else np.nan)


def run_cp_anderson(sp: StackedProblem, z0, eta0, x0, alpha, tol,
                    max_iters: int, memory: int = 5, theta: float = 1.0,
                    reg: float = 1e-10, check_every: int = 1):
    """Safeguarded Anderson-accelerated CP (JAX ``accel.py:144``). Returns
    (z, eta, iters, t_evals, err, hist): z/eta as tensors, err NumPy [3],
    hist NumPy [iters, 6] (NaN rows between strided checks).

    Accept the Anderson candidate iff ||r_cand|| <= theta ||r||, else take
    the plain step w+ = T(w) and evaluate T once more there.
    """
    dt, dev = sp.dtype, sp.device
    a, shift, W, T = _start(sp, z0, eta0, alpha, x0)
    R = _sub(T, W)                          # r = T(w) - w, extended
    err = _residual_row(sp, W, T, a)[:3]
    dW = _h_zeros(W, memory)
    dR = _h_zeros(W, memory)
    G = torch.zeros((memory, memory), dtype=dt, device=dev)
    reg_eye = reg * torch.eye(memory, dtype=dt, device=dev)
    slots = torch.arange(memory, device=dev)
    hist = _history(max_iters, check_every)
    k, evals, pushes = 0, 1, 0
    while k == 0 or (err.max() > tol and k < max_iters + 1):
        valid = (slots < pushes).to(dt)
        Gm = G * (valid[:, None] * valid[None, :]) + reg_eye
        b = _h_dot(dR, R) * valid
        gamma = torch.linalg.solve(Gm, b) * valid
        W_cand = _sub(_add(W, R), _add(_h_combo(dW, gamma),
                                       _h_combo(dR, gamma)))
        T_cand = _t_ext(sp, W_cand, a, x0, shift)
        R_cand = _sub(T_cand, W_cand)
        if pushes > 0 and bool(_read(_norm(R_cand) <= theta * _norm(R))):
            W_new, R_new = W_cand, R_cand
            evals += 1
        else:
            # the plain step w+ = T(w) = w + r; one more T evaluation
            # refreshes the residual there
            W_new = _add(W, R)
            R_new = _sub(_t_ext(sp, W_new, a, x0, shift), W_new)
            evals += 2
        if check_every == 1 or (k + 1) % check_every == 0:
            hist[k] = _residual_row(sp, W_new, _add(W_new, R_new), a)
            err = hist[k, :3]
        slot = pushes % memory
        row = _sub(R_new, R)
        _h_set(dR, slot, row)
        _h_set(dW, slot, _sub(W_new, W))
        g_row = _h_dot(dR, row)              # fills the slot's row + column
        G[slot, :] = g_row
        G[:, slot] = g_row
        W, R = W_new, R_new
        k += 1
        pushes += 1
    z, eta, _, _ = _split(W)
    return z, eta, k, evals, err, hist[:k]


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
    :func:`run_cp_anderson` does.
    """
    dt, dev = sp.dtype, sp.device
    a, shift, W, T = _start(sp, z0, eta0, alpha, x0)
    R = _sub(W, T)                          # R(w) = w - T(w), extended
    err = _residual_row(sp, W, T, a)[:3]
    nr0 = float(_read(_norm(R)))
    U = _h_zeros(W, memory)                 # Broyden vectors u_i
    Y = _h_zeros(W, memory)                 # y_i = r_{i+1} - r_i
    valid = torch.zeros((memory,), dtype=dt, device=dev)
    hist = _history(max_iters, check_every)
    eta_safe = r_safe = eps = nr0
    slot, k, evals = 0, 0, 1

    def apply_h(V):
        w = _h_dot(Y, V) * valid
        return _add(V, _h_combo(U, w))

    def plain_step(j):
        W_p = _sub(W, R)
        return W_p, _sub(W_p, _t_ext(sp, W_p, a, x0, shift)), j + 1

    while k == 0 or (err.max() > tol and k < max_iters + 1):
        norm_r = float(_read(_norm(R)))
        d = tuple(-v for v in apply_h(R))
        if norm_r <= c0 * eta_safe:
            # K0: accept w + d without a test; eta_safe tightens
            W_n = _add(W, d)
            R_n = _sub(W_n, _t_ext(sp, W_n, a, x0, shift))
            eta_safe = norm_r
            ev = 1
        elif norm_r <= r_safe:
            # K1: backtrack until the residual does not grow
            tau, ok, j = 1.0, False, 0
            while not ok and j < ls_max:
                W_c = _add(W, tuple(tau * v for v in d))
                R_c = _sub(W_c, _t_ext(sp, W_c, a, x0, shift))
                norm_c = float(_read(_norm(R_c)))
                ok = norm_c <= c1 * norm_r
                tau *= beta
                j += 1
            if ok:
                W_n, R_n, ev = W_c, R_c, j
                r_safe = norm_c + eps
            else:
                W_n, R_n, ev = plain_step(j)
        else:
            W_n, R_n, ev = plain_step(0)

        # Broyden push: u = (s - H y) / (y.y); degenerate pairs are masked
        s = _sub(W_n, W)
        y = _sub(R_n, R)
        yy = torch.stack([torch.vdot(v.reshape(-1), v.reshape(-1))
                          for v in y[:_TRUE]]).sum()
        good = yy > 1e-30
        denom = torch.where(good, yy, torch.ones_like(yy))
        gz = good.to(dt)
        Hy = apply_h(y)
        _h_set(U, slot, tuple((si - hi) / denom * gz
                              for si, hi in zip(s, Hy)))
        _h_set(Y, slot, y)
        valid[slot] = gz
        slot = (slot + 1) % memory

        if check_every == 1 or (k + 1) % check_every == 0:
            hist[k] = _residual_row(sp, W_n, _sub(W_n, R_n), a)
            err = hist[k, :3]
        W, R = W_n, R_n
        eps *= q_eps
        k += 1
        evals += ev
    z, eta, _, _ = _split(W)
    return z, eta, k, evals, err, hist[:k]
