"""Chambolle-Pock solver for RAOCPs on torch tensors (counterpart of
:mod:`raocp_tpu.solver`, plain CP on one device).

Parity: reference ``raocp/core/solver.py:12`` (``Solver.chock``). The loop
is a host Python loop over eager tensor ops; the host reads the device only
when a residual is checked (every iteration at ``check_every=1``, once per
period otherwise). Like the JAX package it carries L z and L'eta between
iterations, so a step costs two operator applies, plus one for the xi_0
residual at a check.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.core.stacked import StackedProblem, build_stacked
from raocp_tpu_torch.core.variables import (Dual, Primal, tree_add, tree_dot,
                                            tree_inf_norm, tree_sub)
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import (g_conj_projections, half_shift_dual,
                                      prox_f)

__all__ = ["Solver", "SolverResult", "pin_full_precision"]


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to raocp_tpu_torch yet: ROADMAP.md queue 1 "
        f"item {item}")


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
        package can warm-start from it."""
        primal = {f"primal_{k}": np.asarray(v)
                  for k, v in self.primal._asdict().items()}
        dual = {f"dual_{k}": np.asarray(v)
                for k, v in self.dual._asdict().items()}
        np.savez(path, num_iters=self.num_iters, **primal, **dual)

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


def _power_iteration(sp: StackedProblem, max_iters: int = 10000,
                     rel_tol: float = 1e-12):
    """lambda_max(L'L) by power iteration on the primal space, started from
    ``numpy.random.default_rng(0)`` normals (one draw per leaf, in leaf
    order). Returns (lambda as float, iterations)."""
    rng = np.random.default_rng(0)
    z = Primal(*(torch.as_tensor(rng.standard_normal(tuple(l.shape)),
                                 dtype=sp.dtype, device=sp.device)
                 for l in sp.zero_primal()))
    z = _normalise(z, torch.sqrt(tree_dot(z, z)))
    lam, lam_prev = 0.0, -1.0
    k = 0
    while (k < 2 or abs(lam - lam_prev) > rel_tol * abs(lam)) \
            and k < max_iters:
        w = ell_t(sp, ell(sp, z))
        lam_prev, lam = lam, float(tree_dot(z, w))   # Rayleigh quotient
        z = _normalise(w, torch.sqrt(tree_dot(w, w)))
        k += 1
    return lam, k


def _cp_step(sp: StackedProblem, z, eta, Lz, Lt, alpha1, alpha2, x0,
             shift=None):
    """One Chambolle-Pock step (no residuals); carries L z and L'eta so a
    step costs two operator applies. ``shift`` is
    :func:`half_shift_dual` (computed here when not given)."""
    if shift is None:
        shift = half_shift_dual(sp)
    # primal: z+ = prox_f(z - a1 L'eta)
    z_new = prox_f(sp, Primal(*(zi - alpha1 * ti for zi, ti in zip(z, Lt))),
                   alpha1, x0)
    Lzn = ell(sp, z_new)
    # dual: eta+ = prox_g*(eta + a2 L(2 z+ - z)) via Moreau
    mod = Dual(*((e + alpha2 * (2.0 * lzn - lz)) / alpha2 + s
                 for e, lzn, lz, s in zip(eta, Lzn, Lz, shift)))
    proj = g_conj_projections(sp, mod)
    eta_new = Dual(*(alpha2 * (m - p) for m, p in zip(mod, proj)))
    Ltn = ell_t(sp, eta_new)
    return z_new, eta_new, Lzn, Ltn


def _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn, alpha1, alpha2):
    """The xi_0/1/2 and delta_0/1/2 max-norms of one step (reference
    solver.py:63-95) as two 3-element tensors (no host sync). Costs one
    extra operator apply (L' of xi_2)."""
    xi1 = Primal(*((a - b) / alpha1 - (c - d)
                   for a, b, c, d in zip(z, zn, Lt, Ltn)))
    xi2 = Dual(*((a - b) / alpha2 + (c - d)
                 for a, b, c, d in zip(eta, en, Lzn, Lz)))
    xi0 = tree_add(xi1, ell_t(sp, xi2))
    d1 = tree_sub(zn, z)
    d2 = tree_sub(en, eta)
    d0 = Primal(*(a - (b - c) for a, b, c in zip(d1, Ltn, Lt)))
    err = torch.stack([tree_inf_norm(xi0), tree_inf_norm(xi1),
                       tree_inf_norm(xi2)])
    derr = torch.stack([tree_inf_norm(d0), tree_inf_norm(d1),
                        tree_inf_norm(d2)])
    return err, derr


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
    """One residual-balancing update of (alpha1, alpha2, phi) (tensors)."""
    grow = err[1] > _ADAPT_DELTA * err[2]     # primal residual dominates
    shrink = err[2] > _ADAPT_DELTA * err[1]   # dual residual dominates
    one = torch.ones_like(phi)
    fac = torch.where(grow, 1.0 / (1.0 - phi),
                      torch.where(shrink, 1.0 - phi, one))
    phi_new = torch.where(grow | shrink, phi * _ADAPT_DECAY, phi)
    return a1 * fac, a2 / fac, phi_new


def _run_cp(sp: StackedProblem, z0, eta0, x0, alpha1, alpha2, tol,
            max_iters: int, check_every: int = 1, unroll: int = 1,
            adaptive: bool = False, relax: float = 1.0):
    """The CP loop with the JAX package's semantics. Returns (z, eta,
    iters, final errors as NumPy [3], history NumPy [iters, 6]).

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
                hist[k + i] = row
                err_np = row[:3]
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


class Solver:
    """Builds the stacked problem + offline factorisations on ``device``,
    then solves with plain Chambolle-Pock.

    Building a Solver pins full-float32 matmul precision for the process
    (:func:`pin_full_precision`: TF32 off in cuBLAS and cuDNN, "highest"
    float32 matmul precision), which the solver needs to reach its
    tolerances in float32.

    ``dtype`` defaults to float64 on the CPU and float32 on a GPU.
    ``mesh`` (multi-device runs) is not ported yet.
    """

    def __init__(self, problem_spec: RAOCP, dtype=None,
                 pad_multiple: Optional[int] = None, offline: str = "host",
                 mesh=None, device="cpu"):
        if mesh is not None:
            raise _not_ported("a multi-device mesh", 14)
        pin_full_precision()
        self.__spec = problem_spec
        self.__stacked = build_stacked(
            problem_spec, dtype=dtype,
            pad_multiple=1 if pad_multiple is None else pad_multiple,
            offline=offline, device=device)
        self.__result: Optional[SolverResult] = None
        self.__lambda_max: Optional[float] = None
        self.power_iterations: Optional[int] = None

    def operator_norm_sq(self) -> float:
        """lambda_max(L'L), memoised per Solver."""
        if self.__lambda_max is None:
            lam, self.power_iterations = _power_iteration(self.__stacked)
            self.__lambda_max = float(lam)
        return self.__lambda_max

    @property
    def stacked(self) -> StackedProblem:
        return self.__stacked

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
        :param check_every: evaluate the residuals every k-th iteration
        :param unroll: CP steps per loop trip (must divide check_every)
        :param step_ratio: alpha1 = gamma * alpha, alpha2 = alpha / gamma
        :param adaptive: residual balancing of alpha1/alpha2 at each check
        :param relax: over-relaxation rho in (0, 2), or ``"auto"`` (1.8)

        ``log_every``, ``profile_dir``, ``accel``, ``chunk_iters`` and
        ``checkpoint_on_fault`` are not ported yet and raise.
        """
        if accel is not None:
            raise _not_ported(f"accel={accel!r}", 11)
        if chunk_iters is not None or checkpoint_on_fault is not None:
            raise _not_ported("chunked solves (chunk_iters, "
                              "checkpoint_on_fault)", 9)
        if log_every is not None or profile_dir is not None:
            raise _not_ported("log_every / profile_dir", 9)
        sp = self.__stacked
        relax = _resolve_relax(relax)
        x0_np = np.asarray(initial_state, dtype=np.float64).reshape(-1)
        if x0_np.shape != (sp.n,):
            raise ValueError(f"initial state must have {sp.n} entries")
        if step_ratio <= 0.0:
            raise ValueError(f"step_ratio must be positive, got {step_ratio}")
        if not 0.0 < relax < 2.0:
            raise ValueError(f"relax must lie in (0, 2), got {relax}")
        x0 = torch.as_tensor(x0_np, dtype=sp.dtype, device=sp.device)
        if alpha is None:
            alpha = 0.999 / self.operator_norm_sq()
        if warm_start is None:
            z0 = sp.zero_primal()
            z0.x[0] = x0             # reference cache_initial_state
            eta0 = sp.zero_dual()
        else:
            def conv(v):
                if not isinstance(v, torch.Tensor):
                    v = np.asarray(v)
                return torch.as_tensor(v, dtype=sp.dtype, device=sp.device)

            z0 = Primal(*map(conv, warm_start[0]))
            eta0 = Dual(*map(conv, warm_start[1]))
        if sp.device.type == "cuda":
            torch.cuda.synchronize(sp.device)
        tic = time.perf_counter()
        z, eta, iters, err, hist = _run_cp(
            sp, z0, eta0, x0, alpha * step_ratio, alpha / step_ratio, tol,
            max_iters, check_every, unroll, adaptive, relax)
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
            primal=Primal(*(v.cpu().numpy() for v in z)),
            dual=Dual(*(v.cpu().numpy() for v in eta)),
        )
        return self.__result

    def chock(self, initial_state, max_iters: int = 10,
              tol: float = 1e-5) -> int:
        """Reference-parity entry point (``solver.py:97``): returns 0 on
        convergence, 1 otherwise; rich results stay on :attr:`result`."""
        return self.solve(initial_state, max_iters=max_iters, tol=tol).status

    # -- not ported yet ----------------------------------------------------

    def solve_batch(self, *args, **kwargs):
        raise _not_ported("solve_batch", 10)

    def validate(self, *args, **kwargs):
        raise _not_ported("validate", 9)

    def print_states(self, *args, **kwargs):
        raise _not_ported("print_states", 9)

    def print_inputs(self, *args, **kwargs):
        raise _not_ported("print_inputs", 9)

    def plot_residuals(self, *args, **kwargs):
        raise _not_ported("plot_residuals", 9)

    def plot_solution(self, *args, **kwargs):
        raise _not_ported("plot_solution", 9)

    def save_residuals_tex(self, *args, **kwargs):
        raise _not_ported("save_residuals_tex", 9)

    def save_solution_tex(self, *args, **kwargs):
        raise _not_ported("save_solution_tex", 9)
