"""Problem elements: node kinds, linear dynamics, quadratic costs, AVaR risk.

Capability parity with the reference's element layer (``raocp/core/nodes.py``,
``dynamics.py``, ``costs.py``, ``risks.py``), redesigned for the batched build:
an element is an immutable declarative *value* (enum / frozen dataclass),
and anything derived from it — matrix square roots, the conic form of a risk
ambiguity set — is produced by a pure realization function at build time.
The builder (:mod:`raocp_tpu_torch.core.spec`) stores one instance per distinct
element and an index per node; the stacking pass
(:mod:`raocp_tpu_torch.core.stacked`) turns realized elements into padded device
arrays.
"""

import dataclasses
import enum
from typing import NamedTuple, Optional

import numpy as np
from scipy.linalg import sqrtm

import raocp_tpu_torch.core.constraints.cones as cones

__all__ = ["NodeKind", "Node", "Nonleaf", "Leaf", "Dynamics", "Quadratic",
           "ConicForm", "avar_conic_form", "AVaR", "max_over_ambiguity",
           "tv_conic_form", "TotalVariation",
           "msd_conic_form", "MeanUpperSemideviation",
           "wasserstein_conic_form", "Wasserstein",
           "l2ball_conic_form", "L2Ball", "ConicRisk"]


# ---------------------------------------------------------------------------
# node kinds
# ---------------------------------------------------------------------------

class NodeKind(enum.Enum):
    """Which tree positions an element applies to.

    The reference models this as a three-class hierarchy
    (``nodes.py:3,16,25``); a closed enum with the same two predicates is the
    value-semantics equivalent.
    """

    GENERIC = "generic"
    NONLEAF = "nonleaf"
    LEAF = "leaf"

    @property
    def is_nonleaf(self) -> bool:
        return self is NodeKind.NONLEAF

    @property
    def is_leaf(self) -> bool:
        return self is NodeKind.LEAF


def Node() -> NodeKind:
    """Generic (untagged) node kind."""
    return NodeKind.GENERIC


def Nonleaf() -> NodeKind:
    """Internal-node kind (has children; carries controls)."""
    return NodeKind.NONLEAF


def Leaf() -> NodeKind:
    """Terminal-node kind (no children, state only)."""
    return NodeKind.LEAF


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------

def _as_matrix(value, label: str) -> np.ndarray:
    out = np.asarray(value, dtype=np.float64)
    if out.ndim != 2:
        raise ValueError(f"{label} must be a 2-D matrix, got shape {out.shape}")
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Dynamics:
    """One mode of the linear system ``x+ = A x + B u``.

    Parity: reference ``dynamics.py:3`` (row-count agreement enforced).
    """

    state_dynamics: np.ndarray
    control_dynamics: np.ndarray

    def __post_init__(self):
        a = _as_matrix(self.state_dynamics, "state dynamics (A)")
        b = _as_matrix(self.control_dynamics, "control dynamics (B)")
        if a.shape[0] != b.shape[0]:
            raise ValueError(
                f"A has {a.shape[0]} rows but B has {b.shape[0]} — the "
                "dynamics matrices must agree on the state dimension")
        object.__setattr__(self, "state_dynamics", a)
        object.__setattr__(self, "control_dynamics", b)

    @property
    def state_size(self) -> int:
        return self.state_dynamics.shape[1]

    @property
    def control_size(self) -> int:
        return self.control_dynamics.shape[1]


# ---------------------------------------------------------------------------
# quadratic cost
# ---------------------------------------------------------------------------

def _psd_sqrt(weights: np.ndarray, label: str) -> np.ndarray:
    """Symmetric matrix square root (the factor the L operator consumes)."""
    w = _as_matrix(weights, label)
    if w.shape[0] != w.shape[1]:
        raise ValueError(f"{label} must be square, got shape {w.shape}")
    return np.real(sqrtm(w))


@dataclasses.dataclass(frozen=True, eq=False)
class Quadratic:
    """Quadratic stage cost ``x'Qx`` (+ ``u'Ru`` on nonleaf nodes).

    Parity: reference ``costs.py:4``. Only the square roots enter the solver
    (they form the SOC rows of the L operator), so they are realized once
    here, at declaration time, on the host.
    """

    node_type: NodeKind
    state_weights: np.ndarray
    control_weights: Optional[np.ndarray] = None
    sqrt_state_weights: np.ndarray = dataclasses.field(init=False)
    sqrt_control_weights: Optional[np.ndarray] = dataclasses.field(init=False)

    def __post_init__(self):
        kind = self.node_type
        if kind.is_nonleaf:
            if self.control_weights is None:
                raise ValueError("nonleaf quadratic cost needs control "
                                 "weights (R)")
        elif kind.is_leaf:
            if self.control_weights is not None:
                raise ValueError("leaf quadratic cost takes no control "
                                 "weights")
        else:
            raise ValueError("quadratic cost needs a Nonleaf() or Leaf() tag")
        object.__setattr__(
            self, "state_weights",
            _as_matrix(self.state_weights, "state weights (Q)"))
        object.__setattr__(
            self, "sqrt_state_weights",
            _psd_sqrt(self.state_weights, "state weights (Q)"))
        if kind.is_nonleaf:
            object.__setattr__(
                self, "control_weights",
                _as_matrix(self.control_weights, "control weights (R)"))
            object.__setattr__(
                self, "sqrt_control_weights",
                _psd_sqrt(self.control_weights, "control weights (R)"))
        else:
            object.__setattr__(self, "sqrt_control_weights", None)

    def __str__(self) -> str:
        return f"Cost item; type: {type(self).__name__}"

    __repr__ = __str__


# ---------------------------------------------------------------------------
# risk measures
# ---------------------------------------------------------------------------

class ConicForm(NamedTuple):
    """Conic description ``{mu : E mu + F nu <=_K b}`` of an ambiguity set."""

    matrix_e: np.ndarray
    matrix_f: np.ndarray
    cone: "cones.Cartesian"
    vector_b: np.ndarray


def max_over_ambiguity(form: ConicForm, z) -> float:
    """rho(z) = max { z'mu : exists nu, b - E mu - F nu in K } (host-side).

    K rows are read from the cone components: NnOC rows become
    inequalities, Zero rows equalities, Real rows are dropped
    (unconstrained). Purely polyhedral sets solve by linear programming
    (scipy HiGHS); a SecondOrderCone block adds the constraint
    ``||slack[:-1]|| <= slack[-1]`` and the program solves by SLSQP (the
    problem is convex, so the local solution is global). This is the risk
    value of the random outcome ``z`` under the ambiguity set — the
    quantity the solver's epigraph recursion bounds
    (s_i >= rho_i(tau_children + s_children))."""
    import scipy.optimize

    z = np.asarray(z, dtype=np.float64).reshape(-1)
    E, F = form.matrix_e, form.matrix_f
    b = form.vector_b.reshape(-1)
    c, w = E.shape[1], F.shape[1]
    if z.size != c:
        raise ValueError(f"risk outcome has {z.size} entries, ambiguity set "
                         f"has {c}")
    comps = (form.cone.cones if isinstance(form.cone, cones.Cartesian)
             else [form.cone])
    kinds = []
    soc_blocks = []
    for comp in comps:
        if isinstance(comp, cones.NonnegativeOrthant):
            kinds.extend(["ub"] * comp.dimension)
        elif isinstance(comp, cones.Zero):
            kinds.extend(["eq"] * comp.dimension)
        elif isinstance(comp, cones.Real):
            kinds.extend(["free"] * comp.dimension)
        elif isinstance(comp, cones.SecondOrderCone):
            soc_blocks.append((len(kinds), comp.dimension))
            kinds.extend(["soc"] * comp.dimension)
        else:
            raise NotImplementedError(
                f"risk evaluation supports NnOC/Zero/Real/SOC cone rows, "
                f"got {type(comp).__name__}")
    kinds = np.asarray(kinds)
    G = np.hstack([E, F])
    ub = kinds == "ub"
    eq = kinds == "eq"
    obj = np.concatenate([z, np.zeros(w)])

    if not soc_blocks:
        res = scipy.optimize.linprog(
            c=-obj,
            A_ub=G[ub] if ub.any() else None,
            b_ub=b[ub] if ub.any() else None,
            A_eq=G[eq] if eq.any() else None,
            b_eq=b[eq] if eq.any() else None,
            bounds=[(None, None)] * (c + w), method="highs")
        if not res.success:
            raise RuntimeError(f"risk-evaluation LP failed: {res.message}")
        return float(-res.fun)

    constraints = []
    if ub.any():
        constraints.append({"type": "ineq",
                            "fun": lambda v, Gu=G[ub], bu=b[ub]: bu - Gu @ v})
    if eq.any():
        constraints.append({"type": "eq",
                            "fun": lambda v, Ge=G[eq], be=b[eq]: be - Ge @ v})
    for start, dim in soc_blocks:
        Gs, bs = G[start:start + dim], b[start:start + dim]

        # smooth, equivalent form of ||s[:-1]|| <= s[-1]: the squared
        # margin plus nonnegativity of the radial row (SLSQP's linesearch
        # fails on the nonsmooth norm at the cone boundary)
        def soc_margin_sq(v, Gs=Gs, bs=bs):
            s = bs - Gs @ v
            return s[-1] * s[-1] - s[:-1] @ s[:-1]

        def soc_radial(v, Gs=Gs, bs=bs):
            return (bs - Gs @ v)[-1]

        constraints.append({"type": "ineq", "fun": soc_margin_sq})
        constraints.append({"type": "ineq", "fun": soc_radial})
    # start from the least-squares point of the equality rows (a natural
    # interior-ish anchor, e.g. the nominal distribution for simplex sets)
    if eq.any():
        v0, *_ = np.linalg.lstsq(G[eq], b[eq], rcond=None)
    else:
        v0 = np.zeros(c + w)
    res = scipy.optimize.minimize(
        lambda v: -(obj @ v), v0, constraints=constraints, method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12})
    if not res.success:
        # SLSQP's linesearch can stall at the cone boundary even on the
        # smoothed form; trust-constr is slower but markedly more robust
        # on these small convex programs
        res2 = scipy.optimize.minimize(
            lambda v: -(obj @ v), res.x if np.all(np.isfinite(res.x))
            else v0, constraints=constraints, method="trust-constr",
            options={"maxiter": 2000, "gtol": 1e-10})
        # worst constraint margin at a candidate: <= 0 exactly when
        # infeasible (equality rows count ANY nonzero residual against the
        # margin, so a positive eq residual is not mistaken for slack)
        def worst_margin(v):
            margins = []
            for c_ in constraints:
                vals = np.atleast_1d(c_["fun"](v))
                if c_["type"] == "eq":
                    margins.append(-float(np.max(np.abs(vals))))
                else:
                    margins.append(float(np.min(vals)))
            return min(margins, default=0.0)

        if res2.success and worst_margin(res2.x) > -1e-8:
            # trust-constr can report success at xtol stagnation while
            # marginally infeasible; only accept a verified-feasible point
            return float(-res2.fun)
        # diagnosable failure: report both solver messages, the candidate
        # value, and the worst constraint violation at the candidate
        worst = worst_margin(res2.x)
        raise RuntimeError(
            "risk-evaluation SOCP failed: "
            f"SLSQP: {res.message!r}; trust-constr: {res2.message!r} "
            f"(success={res2.success}); "
            f"candidate rho={float(-res2.fun):.6g}, "
            f"worst constraint margin {worst:.3e} (>=0 is feasible)")
    return float(-res.fun)


def avar_conic_form(alpha: float, child_probs) -> ConicForm:
    """Realize the AVaR_alpha ambiguity set for given child probabilities.

    With ``c`` children and conditional probabilities ``pi`` the set is
    ``{mu : E mu <=_K b}``, ``E = [alpha*I; -I; 1']``, ``F`` empty,
    ``K = NnOC(2c) x Zero(1)``, ``b = [pi; 0_c; 1]`` (parity: reference
    ``risks.py:28-35``).
    """
    pi = np.asarray(child_probs, dtype=np.float64).reshape(-1)
    c = pi.size
    eye_c = np.eye(c)
    matrix_e = np.concatenate(
        [alpha * eye_c, -eye_c, np.ones((1, c))], axis=0)
    matrix_f = np.empty((2 * c + 1, 0))
    cone = cones.Cartesian([cones.NonnegativeOrthant(dimension=2 * c),
                            cones.Zero(dimension=1)])
    vector_b = np.concatenate([pi, np.zeros(c), [1.0]]).reshape(-1, 1)
    return ConicForm(matrix_e, matrix_f, cone, vector_b)


class AVaR:
    """Average Value at Risk at level ``alpha`` (a coherent risk measure).

    Declared with only ``alpha``; assigning :attr:`probs` (the conditional
    child probabilities of a node) realizes the conic form of the ambiguity
    set via :func:`avar_conic_form`. Parity: reference ``risks.py:5``.
    """

    is_risk = True

    def __init__(self, alpha: float):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(
                f"AVaR level must lie in [0, 1], got {alpha}")
        self._alpha = float(alpha)
        self._probs: Optional[np.ndarray] = None
        self._conic: Optional[ConicForm] = None

    def for_children(self, child_probs) -> "AVaR":
        """A realized copy of this risk for one node's child probabilities."""
        realized = AVaR(self._alpha)
        realized.probs = child_probs
        return realized

    @property
    def alpha(self) -> float:
        return self._alpha

    @property
    def probs(self) -> Optional[np.ndarray]:
        return self._probs

    @probs.setter
    def probs(self, child_probs) -> None:
        self._probs = np.asarray(child_probs, dtype=np.float64).reshape(-1)
        self._conic = avar_conic_form(self._alpha, self._probs)

    def _realized(self) -> ConicForm:
        if self._conic is None:
            raise ValueError("risk not realized — assign .probs first")
        return self._conic

    @property
    def matrix_e(self) -> np.ndarray:
        return self._realized().matrix_e

    @property
    def matrix_f(self) -> np.ndarray:
        return self._realized().matrix_f

    @property
    def cone(self):
        return self._realized().cone

    @property
    def vector_b(self) -> np.ndarray:
        return self._realized().vector_b

    def evaluate(self, z) -> float:
        """The risk value rho(z) of a per-child outcome vector z (requires
        realized :attr:`probs`). See :func:`max_over_ambiguity`."""
        return max_over_ambiguity(self._realized(), z)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return (f"Risk item; type: {type(self).__name__}, "
                f"alpha: {self._alpha}; cone: {cone}")

    __repr__ = __str__


class _ConicRiskBase:
    """Shared protocol of conic-representable risk measures.

    A risk is declared parameter-only; assigning :attr:`probs` (one node's
    conditional child probabilities) realizes its ambiguity set
    ``{mu : exists nu, b - E mu - F nu in K}`` as a :class:`ConicForm` via
    the subclass's ``_make_form``. The builder's ``with_all_risks`` and the
    stacking pass consume only this protocol, so any risk with a polyhedral
    (NnOC/Zero/Real row) cone plugs into the solver unchanged — the
    reference hardwires the single instance AVaR (``risks.py:5``); the
    conic machinery itself (``cache.py:235-247``, ``operators.py:29-31``)
    is risk-agnostic, which this class makes explicit.
    """

    is_risk = True

    def __init__(self):
        self._probs: Optional[np.ndarray] = None
        self._conic: Optional[ConicForm] = None

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        raise NotImplementedError

    def for_children(self, child_probs) -> "_ConicRiskBase":
        """A realized copy of this risk for one node's child probabilities."""
        import copy

        realized = copy.deepcopy(self)
        realized.probs = child_probs
        return realized

    @property
    def probs(self) -> Optional[np.ndarray]:
        return self._probs

    @probs.setter
    def probs(self, child_probs) -> None:
        self._probs = np.asarray(child_probs, dtype=np.float64).reshape(-1)
        self._conic = self._make_form(self._probs)

    def _realized(self) -> ConicForm:
        if self._conic is None:
            raise ValueError("risk not realized — assign .probs first")
        return self._conic

    @property
    def matrix_e(self) -> np.ndarray:
        return self._realized().matrix_e

    @property
    def matrix_f(self) -> np.ndarray:
        return self._realized().matrix_f

    @property
    def cone(self):
        return self._realized().cone

    @property
    def vector_b(self) -> np.ndarray:
        return self._realized().vector_b

    def evaluate(self, z) -> float:
        """The risk value rho(z) of a per-child outcome vector z (requires
        realized :attr:`probs`). See :func:`max_over_ambiguity`."""
        return max_over_ambiguity(self._realized(), z)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return f"Risk item; type: {type(self).__name__}; cone: {cone}"

    __repr__ = __str__


def tv_conic_form(radius: float, child_probs) -> ConicForm:
    """Realize the total-variation ambiguity set for given probabilities.

    The set is ``{mu in simplex : ||mu - pi||_1 <= radius}`` — the
    distributionally-robust expectation over it is a coherent risk measure
    interpolating expectation (radius 0) and worst case (radius >= 2).
    With the elementwise auxiliary bound ``t >= |mu - pi|`` it is the conic
    form ``{mu : exists t, b - E mu - F t in K}`` (same convention as
    :func:`avar_conic_form`):

      mu - t <= pi ;  -mu - t <= -pi ;  1't <= radius ;  -mu <= 0   (NnOC)
      1'mu = 1                                                      (Zero)

    so ``E = [I; -I; 0'; -I; 1']`` (3c+2 rows), ``F = [-I; -I; 1'; 0; 0']``
    (width c), ``K = NnOC(3c+1) x Zero(1)``, ``b = [pi; -pi; radius; 0; 1]``.
    Unlike AVaR, F is nonzero — this exercises the general ``F'y = 0`` rows
    of the risk-recursion kernel (reference ``cache.py:239-241``).
    """
    pi = np.asarray(child_probs, dtype=np.float64).reshape(-1)
    c = pi.size
    eye_c = np.eye(c)
    ones_c = np.ones((1, c))
    zeros_c = np.zeros((1, c))
    matrix_e = np.concatenate(
        [eye_c, -eye_c, zeros_c, -eye_c, ones_c], axis=0)
    matrix_f = np.concatenate(
        [-eye_c, -eye_c, ones_c, np.zeros((c, c)), zeros_c], axis=0)
    cone = cones.Cartesian([cones.NonnegativeOrthant(dimension=3 * c + 1),
                            cones.Zero(dimension=1)])
    vector_b = np.concatenate(
        [pi, -pi, [float(radius)], np.zeros(c), [1.0]]).reshape(-1, 1)
    return ConicForm(matrix_e, matrix_f, cone, vector_b)


class TotalVariation(_ConicRiskBase):
    """Distributionally robust expectation over a total-variation ball.

    ``rho(Z) = max { E_mu[Z] : mu in simplex, ||mu - pi||_1 <= radius }``.
    ``radius = 0`` is the (risk-neutral) expectation, ``radius >= 2`` the
    worst-case (max) measure. A capability beyond the reference (which
    ships only AVaR, ``risks.py:5``) enabled by the risk-agnostic conic
    machinery — see :class:`_ConicRiskBase`.
    """

    def __init__(self, radius: float):
        if radius < 0.0:
            raise ValueError(
                f"total-variation radius must be nonnegative, got {radius}")
        super().__init__()
        self._radius = float(radius)

    @property
    def radius(self) -> float:
        return self._radius

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        return tv_conic_form(self._radius, child_probs)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return (f"Risk item; type: {type(self).__name__}, "
                f"radius: {self._radius}; cone: {cone}")

    __repr__ = __str__


def msd_conic_form(beta: float, child_probs) -> ConicForm:
    """Realize the mean-upper-semideviation ambiguity set.

    ``rho(Z) = E[Z] + beta * E[(Z - E[Z])_+]`` (coherent for beta in
    [0, 1]) has the dual representation ``A = { mu = pi o (1 + h - <pi,h>)
    : 0 <= h <= beta }`` (Shapiro/Dentcheva/Ruszczynski, Lectures on
    Stochastic Programming, ex. 6.20). With auxiliary variables nu = h the
    conic form (same convention as :func:`avar_conic_form`) is

      mu - pi o h + pi <pi, h> = pi      (c Zero rows: E = I,
                                          F = -diag(pi) + pi pi')
      -h <= 0 ;  h <= beta               (2c NnOC rows, E = 0)

    Zero rows come FIRST here (AVaR/TV put them last) — exercising that
    the stacked layout is truly row-kind-mask driven, not position-driven.
    """
    pi = np.asarray(child_probs, dtype=np.float64).reshape(-1)
    c = pi.size
    eye_c = np.eye(c)
    zeros_cc = np.zeros((c, c))
    matrix_e = np.concatenate([eye_c, zeros_cc, zeros_cc], axis=0)
    matrix_f = np.concatenate(
        [-np.diag(pi) + np.outer(pi, pi), -eye_c, eye_c], axis=0)
    cone = cones.Cartesian([cones.Zero(dimension=c),
                            cones.NonnegativeOrthant(dimension=2 * c)])
    vector_b = np.concatenate(
        [pi, np.zeros(c), np.full(c, float(beta))]).reshape(-1, 1)
    return ConicForm(matrix_e, matrix_f, cone, vector_b)


class MeanUpperSemideviation(_ConicRiskBase):
    """Mean-upper-semideviation risk ``E[Z] + beta * E[(Z - E[Z])_+]``.

    Coherent for ``beta`` in [0, 1]; beta = 0 is the expectation. A
    capability beyond the reference (which ships only AVaR), with a
    closed-form oracle used in tests.
    """

    def __init__(self, beta: float):
        if not 0.0 <= beta <= 1.0:
            raise ValueError(
                f"semideviation weight must lie in [0, 1], got {beta}")
        super().__init__()
        self._beta = float(beta)

    @property
    def beta(self) -> float:
        return self._beta

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        return msd_conic_form(self._beta, child_probs)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return (f"Risk item; type: {type(self).__name__}, "
                f"beta: {self._beta}; cone: {cone}")

    __repr__ = __str__


def wasserstein_conic_form(radius: float, ground_cost,
                           child_probs) -> ConicForm:
    """Realize the Wasserstein-1 (optimal transport) ambiguity set.

    The set is ``{mu in simplex : W_1(mu, pi) <= radius}`` where
    ``W_1(mu, pi) = min { <C, gamma> : gamma >= 0, gamma 1 = pi,
    gamma' 1 = mu }`` is the optimal-transport cost between the nominal
    child distribution pi and mu under the ground-cost matrix
    ``C[i, j] >= 0`` (cost of moving mass from child i to child j;
    ``None`` defaults to ``|i - j|``, the natural metric when children are
    ordered by mode). On finite support this is polyhedral: with the
    transport plan as auxiliary variables ``nu = vec(gamma)``
    (``nu[i*c + j] = gamma[i, j]``) the conic form (same
    ``{mu : exists nu, b - E mu - F nu in K}`` convention as
    :func:`avar_conic_form`) is

      <vec(C), nu> <= radius ;  -nu <= 0          (1 + c^2 NnOC rows, E = 0)
      (I kron 1') nu = pi                         (c Zero rows, E = 0)
      mu - (1' kron I) nu = 0                     (c Zero rows, E = I)

    ``mu >= 0`` and ``1'mu = 1`` follow from the marginal rows, so no
    simplex rows are needed. The discrete metric ``C = 1 - I`` recovers the
    total-variation ball of radius ``2 * radius`` (W_1 with the 0/1 cost is
    half the L1 distance) — the oracle used in tests. The reference ships
    only AVaR (``risks.py:5``); this plugs into its risk-agnostic conic
    machinery (``cache.py:235-247``) via the generic stacked layer.
    """
    pi = np.asarray(child_probs, dtype=np.float64).reshape(-1)
    c = pi.size
    if ground_cost is None:
        idx = np.arange(c, dtype=np.float64)
        cost = np.abs(idx[:, None] - idx[None, :])
    else:
        cost = np.asarray(ground_cost, dtype=np.float64)
        if cost.shape != (c, c):
            raise ValueError(
                f"ground_cost must be ({c}, {c}) for {c} children, "
                f"got {cost.shape}")
        if (cost < 0.0).any():
            raise ValueError("ground_cost entries must be nonnegative")
        # Feasibility: any transport plan with row marginals pi costs at
        # least sum_i pi_i min_j C[i, j] (each unit of mass from child i
        # must go SOMEWHERE). A zero-diagonal (metric) ground cost makes
        # this 0; a positive diagonal can silently empty the ambiguity set
        # — the CP solve then never converges with no diagnosable error.
        min_cost = float(pi @ cost.min(axis=1))
        if radius < min_cost - 1e-12:
            raise ValueError(
                f"empty Wasserstein ambiguity set: radius {radius} is "
                f"below the cheapest feasible transport cost "
                f"sum_i pi_i min_j C[i, j] = {min_cost}; use a larger "
                "radius or a ground cost with a zero diagonal (a metric)")
    w = c * c
    eye_c = np.eye(c)
    ones_r = np.ones((1, c))
    # NnOC block: transport budget + plan nonnegativity
    e_nn = np.zeros((1 + w, c))
    f_nn = np.concatenate([cost.reshape(1, w), -np.eye(w)], axis=0)
    b_nn = np.concatenate([[float(radius)], np.zeros(w)])
    # Zero block: row marginals (= pi), then column marginals (= mu)
    e_zero = np.concatenate([np.zeros((c, c)), eye_c], axis=0)
    f_zero = np.concatenate([np.kron(eye_c, ones_r),
                             -np.kron(ones_r, eye_c)], axis=0)
    b_zero = np.concatenate([pi, np.zeros(c)])
    matrix_e = np.concatenate([e_nn, e_zero], axis=0)
    matrix_f = np.concatenate([f_nn, f_zero], axis=0)
    cone = cones.Cartesian([cones.NonnegativeOrthant(dimension=1 + w),
                            cones.Zero(dimension=2 * c)])
    vector_b = np.concatenate([b_nn, b_zero]).reshape(-1, 1)
    return ConicForm(matrix_e, matrix_f, cone, vector_b)


class Wasserstein(_ConicRiskBase):
    """Distributionally robust expectation over a Wasserstein-1 ball.

    ``rho(Z) = max { E_mu[Z] : mu in simplex, W_1(mu, pi) <= radius }``
    under the ground-cost matrix ``ground_cost`` (``None`` = ``|i - j|``
    on the child indices). Unlike :class:`TotalVariation` (which charges
    every reallocation equally), the transport cost makes shifting mass to
    NEARBY modes cheap and to distant ones expensive — the standard
    data-driven ambiguity set when modes carry a geometry. ``radius = 0``
    is the expectation; with the discrete metric (``1 - I``) it equals
    ``TotalVariation(2 * radius)``. Coherent for any radius >= 0.
    """

    def __init__(self, radius: float, ground_cost=None):
        if radius < 0.0:
            raise ValueError(
                f"Wasserstein radius must be nonnegative, got {radius}")
        super().__init__()
        self._radius = float(radius)
        self._ground_cost = (None if ground_cost is None
                             else np.asarray(ground_cost, dtype=np.float64))

    @property
    def radius(self) -> float:
        return self._radius

    @property
    def ground_cost(self) -> Optional[np.ndarray]:
        return self._ground_cost

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        return wasserstein_conic_form(self._radius, self._ground_cost,
                                      child_probs)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return (f"Risk item; type: {type(self).__name__}, "
                f"radius: {self._radius}; cone: {cone}")

    __repr__ = __str__


def l2ball_conic_form(radius: float, child_probs) -> ConicForm:
    """Realize the Euclidean-ball ambiguity set for given probabilities.

    The set is ``{mu in simplex : ||mu - pi||_2 <= radius}`` — the
    distributionally-robust expectation over it interpolates expectation
    (radius 0) and worst case (radius >= the simplex diameter sqrt(2)).
    As rows of ``b - E mu in K`` (same convention as
    :func:`avar_conic_form`):

      -mu <= 0                       (NnOC, c rows)
      1'mu = 1                       (Zero, 1 row)
      ||mu - pi|| <= radius          (SOC, c+1 rows: x part mu - pi via
                                      E = -I, b = -pi; radial row E = 0,
                                      b = radius — radial LAST, matching
                                      the SecondOrderCone convention)

    so ``E = [-I; 1'; -I; 0']`` (2c+2 rows), ``F`` empty,
    ``K = NnOC(c) x Zero(1) x SOC(c+1)``, ``b = [0_c; 1; -pi; radius]``.
    Unlike every reference risk, K has a non-polyhedral block — this
    exercises the SOC rows of the batched risk-dual projection.
    """
    pi = np.asarray(child_probs, dtype=np.float64).reshape(-1)
    c = pi.size
    eye_c = np.eye(c)
    matrix_e = np.concatenate(
        [-eye_c, np.ones((1, c)), -eye_c, np.zeros((1, c))], axis=0)
    matrix_f = np.empty((2 * c + 2, 0))
    cone = cones.Cartesian([cones.NonnegativeOrthant(dimension=c),
                            cones.Zero(dimension=1),
                            cones.SecondOrderCone(dimension=c + 1)])
    vector_b = np.concatenate([np.zeros(c), [1.0], -pi,
                               [float(radius)]]).reshape(-1, 1)
    return ConicForm(matrix_e, matrix_f, cone, vector_b)


class L2Ball(_ConicRiskBase):
    """Euclidean-ball distributionally robust expectation:
    ``rho(Z) = max { E_mu[Z] : mu in simplex, ||mu - pi||_2 <= radius }``.

    A coherent risk measure with a genuinely second-order-cone ambiguity
    set (AVaR/TV/MSD are all polyhedral): radius 0 is the expectation,
    radius >= sqrt(2) contains the whole simplex (worst case). A
    capability beyond the reference, exercising the SOC rows of the
    batched risk-dual projection.
    """

    def __init__(self, radius: float):
        if radius < 0.0:
            raise ValueError(
                f"ball radius must be nonnegative, got {radius}")
        super().__init__()
        self._radius = float(radius)

    @property
    def radius(self) -> float:
        return self._radius

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        return l2ball_conic_form(self._radius, child_probs)

    def __str__(self) -> str:
        cone = "unrealized" if self._conic is None else self._conic.cone.types
        return (f"Risk item; type: {type(self).__name__}, "
                f"radius: {self._radius}; cone: {cone}")

    __repr__ = __str__


class ConicRisk(_ConicRiskBase):
    """A user-defined conic-representable risk measure.

    ``form_fn(child_probs) -> ConicForm`` supplies the ambiguity set
    ``{mu : exists nu, b - E mu - F nu in K}`` for one node's conditional
    child probabilities. The cone may be any Cartesian product of
    NonnegativeOrthant / Zero / Real components (i.e. any polyhedral
    ambiguity set). Example — a custom expectation-anchored polytope::

        risk = ConicRisk(lambda pi: ConicForm(E(pi), F(pi), K(pi), b(pi)))
        problem.with_all_risks(risk)
    """

    def __init__(self, form_fn):
        super().__init__()
        if not callable(form_fn):
            raise ValueError("ConicRisk needs a callable "
                             "child_probs -> ConicForm")
        self._form_fn = form_fn

    def _make_form(self, child_probs: np.ndarray) -> ConicForm:
        form = self._form_fn(child_probs)
        if not isinstance(form, ConicForm):
            raise TypeError("ConicRisk form_fn must return a ConicForm, got "
                            f"{type(form).__name__}")
        e, f, b = form.matrix_e, form.matrix_f, form.vector_b
        rows = e.shape[0]
        if f.shape[0] != rows or b.reshape(-1).size != rows:
            raise ValueError(
                "ConicForm row mismatch: E has %d rows, F %d, b %d"
                % (rows, f.shape[0], b.reshape(-1).size))
        if e.shape[1] != child_probs.size:
            raise ValueError(
                "E must have one column per child (%d), got %d"
                % (child_probs.size, e.shape[1]))
        return form
