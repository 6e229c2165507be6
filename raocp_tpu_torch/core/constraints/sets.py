"""Per-node constraint sets on the stacked ``[x; u]`` (nonleaf) / ``x`` (leaf)
vector: No (absent), Rectangle (box), Ball (Euclidean norm ball) and
Polyhedral (general ``lb <= G v <= ub``).

Capability parity with the reference's constraint layer
(``raocp/core/constraints/base_constraint.py``, ``rectangle.py``,
``no_constraint.py``; Ball is a new capability for BASELINE config 3, and
Polyhedral delivers the general Gamma-matrix constraint the reference's base
class scaffolds — ``base_constraint.py:88-98`` stores Gamma_x/Gamma_u and
transposes — but never instantiates beyond stacked identities),
redesigned: a constraint is a declarative set description; the builder binds
the vector dimensions once (:meth:`Constraint.bind`), and the
identity-structured selection matrices Gamma_x / Gamma_u — which the batched
device path never materializes — are derived on demand rather than stored and
mutated through setter cascades. The solver enforces a constraint by
projecting the matching dual segment (Moreau); the host-side :meth:`project`
methods exist for spec-level use and oracle tests.
"""

from typing import Optional

import numpy as np

__all__ = ["Constraint", "No", "Rectangle", "Ball", "Polyhedral"]


class Constraint:
    """Declarative constraint set, dimension-bound by the problem builder.

    Subclasses define :attr:`is_active` and :meth:`project`. Dimensions may
    be fixed either with :meth:`bind` or through the reference-compatible
    ``state_size`` / ``control_size`` property assignments.
    """

    def __init__(self, node_type=None):
        self._kind = node_type
        self._n: Optional[int] = None
        self._m: Optional[int] = None

    # -- identity -----------------------------------------------------------

    @property
    def node_type(self):
        return self._kind

    @property
    def is_active(self):
        raise TypeError("the Constraint base class describes no set — "
                        "use No, Rectangle or Ball")

    def _kind_or_raise(self):
        kind = self._kind
        if kind is None or not (kind.is_nonleaf or kind.is_leaf):
            raise ValueError("constraint has no Nonleaf()/Leaf() tag")
        return kind

    # -- dimension binding ----------------------------------------------------

    def bind(self, state_size: int, control_size: Optional[int] = None):
        """Fix the constrained vector's dimensions (idempotent; returns self).

        Leaf constraints act on ``x`` alone, so ``control_size`` is forced
        to zero there.
        """
        if self._kind_or_raise().is_leaf:
            if control_size not in (None, 0):
                raise ValueError("a leaf constraint has no control segment")
            control_size = 0
        self._n = int(state_size)
        if control_size is not None:
            self._m = int(control_size)
        return self

    @property
    def state_size(self) -> Optional[int]:
        return self._n

    @state_size.setter
    def state_size(self, size: int) -> None:
        if self._kind_or_raise().is_leaf:
            self.bind(size)
        else:
            self._n = int(size)

    @property
    def control_size(self) -> Optional[int]:
        return self._m

    @control_size.setter
    def control_size(self, size: int) -> None:
        if self._kind_or_raise().is_leaf:
            raise ValueError("a leaf constraint has no control segment")
        self._m = int(size)

    @property
    def width(self) -> Optional[int]:
        """Length of the constrained vector, or None before binding."""
        if self._n is None:
            return None
        if self._kind is not None and self._kind.is_nonleaf:
            if self._m is None:
                return None
            return self._n + self._m
        return self._n

    # -- derived selection matrices (never stored) -----------------------------

    @property
    def state_matrix(self) -> Optional[np.ndarray]:
        """Gamma_x = [I_n; 0] of shape (width, n); None before binding."""
        w = self.width
        return None if w is None else np.eye(w, self._n)

    @property
    def control_matrix(self) -> Optional[np.ndarray]:
        """Gamma_u = [0; I_m] of shape (width, m); None on leaves/unbound."""
        w = self.width
        if w is None or not self._kind_or_raise().is_nonleaf:
            return None
        return np.eye(w, self._m, k=-self._n)

    @property
    def state_matrix_transposed(self) -> np.ndarray:
        mat = self.state_matrix
        if mat is None:
            raise ValueError("constraint dimensions not bound yet")
        return mat.T

    @property
    def control_matrix_transposed(self) -> np.ndarray:
        mat = self.control_matrix
        if mat is None:
            raise ValueError("constraint dimensions not bound yet, or leaf")
        return mat.T

    # -- set operations ----------------------------------------------------------

    def project(self, vector):
        """Euclidean projection onto the set (host-side; subclass hook)."""
        raise NotImplementedError

    def violation(self, vector) -> float:
        """Max-norm infeasibility of ``vector`` (0 when the point is in the
        set). Default: distance components to the Euclidean projection;
        subclasses with cheaper feasibility certificates override this."""
        flat = self._checked(vector)
        return float(np.abs(flat - self.project(flat).reshape(-1)).max())

    def _checked(self, vector) -> np.ndarray:
        flat = np.asarray(vector, dtype=np.float64).reshape(-1)
        w = self.width
        if w is not None and flat.size != w:
            raise ValueError(
                f"constraint bound to width {w}, got a {flat.size}-vector")
        return flat

    def __str__(self):
        return f"Constraint; type: {type(self).__name__}"

    __repr__ = __str__


class No(Constraint):
    """The absent constraint (whole space); a placeholder for free nodes."""

    is_active = False

    def project(self, vector):
        return np.asarray(vector, dtype=np.float64)


def _bound_vector(values, which: str) -> np.ndarray:
    """Bounds as float vector; None entries become the matching infinity."""
    fill = -np.inf if which == "min" else np.inf
    flat = np.asarray(values, dtype=object).reshape(-1)
    return np.array([fill if v is None else float(v) for v in flat])


class Rectangle(Constraint):
    """Box ``min <= v <= max`` (None entries are unbounded on that side)."""

    is_active = True

    def __init__(self, node_type, _min, _max):
        super().__init__(node_type)
        lo_raw = np.asarray(_min, dtype=object).reshape(-1)
        hi_raw = np.asarray(_max, dtype=object).reshape(-1)
        if lo_raw.size != hi_raw.size:
            raise ValueError("box bounds differ in length: "
                             f"{lo_raw.size} vs {hi_raw.size}")
        if any(a is None and b is None for a, b in zip(lo_raw, hi_raw)):
            raise ValueError("a box coordinate with both bounds None "
                             "constrains nothing — use No instead")
        lo = _bound_vector(lo_raw, "min")
        hi = _bound_vector(hi_raw, "max")
        if np.any(lo > hi):
            raise ValueError("box lower bound exceeds upper bound")
        self._lo = lo
        self._hi = hi

    @property
    def min(self) -> np.ndarray:
        return self._lo

    @property
    def max(self) -> np.ndarray:
        return self._hi

    def project(self, vector):
        flat = self._checked(vector)
        return np.clip(flat, self._lo, self._hi).reshape(np.shape(vector))


class Ball(Constraint):
    """Euclidean-norm ball ``||v - center||_2 <= radius``.

    The radius-``r`` slice of a shifted second-order cone — the norm-ball
    state-input constraint of BASELINE config 3. Not present in the
    reference; wired through the same dual-segment projection path as
    Rectangle. ``center=None`` means the origin (resolved to the bound
    width at stacking time).
    """

    is_active = True

    def __init__(self, node_type, radius, center=None):
        super().__init__(node_type)
        radius = float(radius)
        if not radius > 0:
            raise ValueError(f"ball radius must be positive, got {radius}")
        self._radius = radius
        self._center = (None if center is None else
                        np.asarray(center, dtype=np.float64).reshape(-1))

    @property
    def radius(self) -> float:
        return self._radius

    @property
    def center(self) -> Optional[np.ndarray]:
        return self._center

    def center_for_size(self, size: int) -> np.ndarray:
        if self._center is None:
            return np.zeros(size)
        if self._center.size != size:
            raise ValueError(
                f"ball center has {self._center.size} entries, the "
                f"constrained vector has {size}")
        return self._center

    def project(self, vector):
        flat = self._checked(vector)
        offset = flat - self.center_for_size(flat.size)
        norm = float(np.linalg.norm(offset))
        if norm <= self._radius:
            return np.asarray(vector, dtype=np.float64)
        scaled = self.center_for_size(flat.size) + offset * (self._radius / norm)
        return scaled.reshape(np.shape(vector))


class Polyhedral(Constraint):
    """General linear constraint ``lb <= G v <= ub`` on the node vector.

    The capability the reference's constraint base class scaffolds but never
    ships: arbitrary row matrices instead of stacked identities. The solver
    enforces it exactly like Rectangle — the operator emits the image rows
    ``G [x; u]`` into the constraint dual segment and the dual prox clips
    them to the box — so any polyhedron expressible as a two-sided row
    system batches branch-free (one extra [rows, n+m] matmul in L / L').

    ``lb`` / ``ub`` entries may be None (unbounded on that side). Equality
    rows are expressed as ``lb_r == ub_r``.
    """

    is_active = True

    def __init__(self, node_type, matrix, lb, ub):
        super().__init__(node_type)
        G = np.asarray(matrix, dtype=np.float64)
        if G.ndim != 2:
            raise ValueError(f"constraint matrix must be 2-D, got {G.shape}")
        lo_raw = np.asarray(lb, dtype=object).reshape(-1)
        hi_raw = np.asarray(ub, dtype=object).reshape(-1)
        if lo_raw.size != G.shape[0] or hi_raw.size != G.shape[0]:
            raise ValueError(
                f"bounds must have one entry per row of the matrix "
                f"({G.shape[0]}), got {lo_raw.size} / {hi_raw.size}")
        if any(a is None and b is None for a, b in zip(lo_raw, hi_raw)):
            raise ValueError("a row with both bounds None constrains "
                             "nothing — drop it")
        lo = _bound_vector(lo_raw, "min")
        hi = _bound_vector(hi_raw, "max")
        if np.any(lo > hi):
            raise ValueError("polyhedral lower bound exceeds upper bound")
        self._G = G
        self._lo = lo
        self._hi = hi

    @property
    def matrix(self) -> np.ndarray:
        return self._G

    @property
    def min(self) -> np.ndarray:
        return self._lo

    @property
    def max(self) -> np.ndarray:
        return self._hi

    @property
    def num_rows(self) -> int:
        return self._G.shape[0]

    def bind(self, state_size: int, control_size: Optional[int] = None):
        super().bind(state_size, control_size)
        if self.width is not None and self._G.shape[1] != self.width:
            raise ValueError(
                f"constraint matrix has {self._G.shape[1]} columns, the "
                f"constrained vector has {self.width} entries")
        return self

    # Gamma_x / Gamma_u are the real column blocks of G here, not identities
    @property
    def state_matrix(self) -> Optional[np.ndarray]:
        return None if self._n is None else self._G[:, :self._n]

    @property
    def control_matrix(self) -> Optional[np.ndarray]:
        if self._n is None or not self._kind_or_raise().is_nonleaf:
            return None
        return self._G[:, self._n:]

    def violation(self, vector) -> float:
        """Image-space infeasibility max(0, G v - ub, lb - G v) — zero iff
        the point satisfies every row (no projection solve needed)."""
        flat = self._checked(vector)
        img = self._G @ flat
        over = np.maximum(img - self._hi, 0.0)
        under = np.maximum(self._lo - img, 0.0)
        return float(np.maximum(over, under).max())

    def project(self, vector, max_iters: int = 20000, tol: float = 1e-12):
        """Euclidean projection via Dykstra's algorithm over the row slabs
        ``{v : lb_r <= g_r'v <= ub_r}`` (each slab projection is closed
        form). Host-side oracle for tests/validation — the solver never
        projects onto the polyhedron itself, only onto its image box."""
        flat = self._checked(vector)
        R = self.num_rows
        g = self._G
        g_nrm2 = np.einsum("ij,ij->i", g, g)
        v = flat.copy()
        corr = np.zeros((R, flat.size))
        for _ in range(max_iters):
            v_prev = v.copy()
            for r in range(R):
                w = v + corr[r]
                if g_nrm2[r] == 0.0:
                    v = w
                    corr[r] = 0.0
                    continue
                t = g[r] @ w
                t_clip = min(max(t, self._lo[r]), self._hi[r])
                v = w + (t_clip - t) / g_nrm2[r] * g[r]
                corr[r] = w - v
            if np.abs(v - v_prev).max() <= tol:
                break
        return v.reshape(np.shape(vector))
