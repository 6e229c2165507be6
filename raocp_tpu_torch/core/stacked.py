"""Stacked, padded, device-ready form of a RAOCP, as torch tensors.

Counterpart of :mod:`raocp_tpu.core.stacked`. The offline phase is the same
float64 NumPy code (the backward Riccati-like factorisation, reference
``cache.py:207-233``, and the precomputed kernel projectors
``Pi = I - M'(MM')^{-1}M``, reference ``cache.py:235-242``); only the upload
step differs: every table becomes a tensor on the ``device`` given to
:func:`build_stacked`. Index tensors are ``int64`` and masks are ``bool``.

Padded layouts (d = max branching; Y = max rows of any node's risk matrix E,
e.g. 2d+1 for AVaR, 3d+2 for TotalVariation; D = Y + 2d):

* y / e1 / b / E rows for a node whose risk has R rows sit in slots [0, R)
  in natural (E-row) order; slots beyond R are zero. The dual-cone
  projection is driven by per-node row-kind masks (``risk_free_rows`` /
  ``risk_zero_rows``) built from the risk's cone.
* kernel vector v = [y (Y slots) | tau_children (d slots) | s_children
  (d slots)].
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raocp_tpu_torch.core.modal import (MODAL_MAX_MODES, ModalMatrix,
                                        from_dense_stack, upload)
from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.core.variables import Primal, Dual

__all__ = ["StackedProblem", "build_stacked", "from_numpy", "to_numpy"]

Tensor = torch.Tensor

# the fields that are Python ints / tuples, not tensors
STATIC_FIELDS = ("n", "m", "num_nodes", "num_nonleaf", "num_leaf", "d_max",
                 "num_stages", "stage_start", "stage_child", "np_pad",
                 "nl_pad", "lf_pad", "y_dim", "frontier", "spmd_ndev")
# the per-nonleaf-stage tuples of (tensor or None)
STAGE_FIELDS = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd", "k_s", "rinv_s",
                "sumapb_s", "k_ms", "rinv_ms", "sumapb_ms")
MODAL_FIELDS = ("Am", "Bm", "ABm", "sqrtQ", "sqrtR", "QRm", "sqrtP")


@dataclasses.dataclass(frozen=True)
class StackedProblem:
    """All tensors + static metadata of one RAOCP instance (field for field
    the JAX package's ``StackedProblem``; ``spmd_group`` stands for its
    ``spmd_axis``)."""

    # -- static metadata ---------------------------------------------------
    n: int
    m: int
    num_nodes: int
    num_nonleaf: int
    num_leaf: int
    d_max: int
    num_stages: int
    stage_start: Tuple[int, ...]
    # per nonleaf stage: the uniform child count, or None when branching is
    # ragged within that stage
    stage_child: Tuple[Optional[int], ...]
    # padded row counts of the three node spaces (ghost rows stay zero)
    np_pad: int
    nl_pad: int
    lf_pad: int
    # width of the padded y / e1 / b row space
    y_dim: int

    # -- index plans -------------------------------------------------------
    anc: Tensor             # [np_pad] parent (anc[0] = 0), int64
    child_idx: Tensor       # [nl_pad, d_max] child node ids, 0-padded, int64
    child_mask: Tensor      # [nl_pad, d_max] 1.0 where valid
    child_rank: Tensor      # [np_pad] rank among siblings (root 0), int64
    nz_mask: Tensor         # [np_pad] 0.0 at root, 1.0 elsewhere
    # [nl_pad, Y] bool risk-cone row kinds (Zero rows / Real rows)
    risk_free_rows: Tensor
    risk_zero_rows: Tensor
    # [nl_pad, Y] bool SOC member / radial rows, or None without SOC blocks
    risk_soc_rows: Optional[Tensor]
    risk_soc_tail: Optional[Tensor]

    # -- problem data --------------------------------------------------------
    A: Optional[Tensor]     # [np_pad, n, n] (only with keep_dense)
    B: Optional[Tensor]     # [np_pad, n, m]
    Am: ModalMatrix         # mode-grouped A (mode 0 = zero; root/pad rows)
    Bm: ModalMatrix         # mode-grouped B
    ABm: ModalMatrix        # mode-grouped [A | B]
    sqrtQ: ModalMatrix
    sqrtR: ModalMatrix
    QRm: Optional[ModalMatrix]   # mode-grouped blockdiag(sqrtQ, sqrtR)
    sqrtP: ModalMatrix
    b_pad: Tensor           # [nl_pad, Y] risk vector b (padded layout)
    y_mask: Tensor          # [nl_pad, Y] 1.0 on real y coordinates
    nl_lo: Tensor           # [nl_pad, rows] lower bound (-inf where free)
    nl_hi: Tensor
    nl_active: Tensor       # [nl_pad] 1.0 where the constraint is active
    nl_ball_c: Tensor       # [nl_pad, rows] Ball centers
    nl_ball_r: Tensor       # [nl_pad] Ball radii (+inf where not Ball)
    l_lo: Tensor            # [lf_pad, rows]
    l_hi: Tensor
    l_active: Tensor
    l_ball_c: Tensor
    l_ball_r: Tensor
    nl_G: Optional[Tensor]  # shared Polyhedral row matrix or None
    l_G: Optional[Tensor]

    # -- stage-stacked mode blocks (one entry per nonleaf stage) -------------
    ab_fwd: Tuple[Optional[Tensor], ...]   # [F, c, n]   x_children
    ab_bwd: Tuple[Optional[Tensor], ...]   # [c, n, F]   sum A'q | B'q
    qr_fwd: Tuple[Optional[Tensor], ...]   # [F, c, F]   e3/e4 rows
    qr_bwd: Tuple[Optional[Tensor], ...]   # [c, F, F]   sum Q'e3 | R'e4
    # stage-constant Riccati tables (None where not stage-constant)
    k_s: Tuple[Optional[Tensor], ...]       # [m, n]
    rinv_s: Tuple[Optional[Tensor], ...]    # [m, m]
    sumapb_s: Tuple[Optional[Tensor], ...]  # [n, m]

    # -- offline factorisations (dense stacks only where the solve reads
    #    them, or with keep_dense) -------------------------------------------
    P: Optional[Tensor]
    Rinv: Optional[Tensor]
    K: Optional[Tensor]
    Abar: Optional[Tensor]
    sumAPB: Optional[Tensor]
    Pi: Tensor              # [nl_pad, D, D] kernel projectors (padded)

    # -- subtree-partition metadata (set only by
    #    parallel.subtree.build_subtree_problem) ---------------------------
    # The tensors are then ONE rank's block of a replicated-spine subtree
    # partition: stages [0, frontier) are replicated on every rank, stages
    # >= frontier are split evenly (each rank owns complete subtrees; uneven
    # stages carry interior ghost rows that stay zero). The ops run
    # rank-locally except at the frontier crossing, where the child
    # reductions complete with an all-reduce over ``spmd_group``
    # (ops.operator._frontier_psum).
    frontier: Optional[int] = None
    spmd_group: Optional[object] = None     # torch.distributed ProcessGroup
    spmd_ndev: Optional[int] = None
    # 1.0 on real rows of the all-node / leaf space (None: real rows are a
    # prefix): the interior ghost rows of a partition's block
    node_mask: Optional[Tensor] = None
    lf_half_mask: Optional[Tensor] = None

    # -- mode-constant Riccati tables (post-stopping chain stages) -----------
    k_ms: Tuple[Optional[Tensor], ...] = ()       # [M, m, n]
    rinv_ms: Tuple[Optional[Tensor], ...] = ()    # [M, m, m]
    sumapb_ms: Tuple[Optional[Tensor], ...] = ()  # [M, n, m]
    riccati_cls: Optional[Tensor] = None          # [np_pad] int64

    # -- flat-partition metadata (set only by
    #    parallel.sharding.shard_problem) -------------------------------------
    # The tensors are then ONE rank's even row block of every node-,
    # nonleaf- and leaf-leading field (np_pad / nl_pad / lf_pad are the
    # block's rows; num_nodes, stage_start, ... stay global), and ``flat``
    # is the rank's exchange plan (parallel.flat.FlatPlan): the ops read the
    # rows other ranks own through its planned halo exchanges.
    flat: Optional[object] = None

    # -- convenience ---------------------------------------------------------

    @property
    def Y(self) -> int:
        return self.y_dim

    @property
    def D(self) -> int:
        return self.y_dim + 2 * self.d_max

    @property
    def dtype(self) -> torch.dtype:
        return self.b_pad.dtype

    @property
    def device(self) -> torch.device:
        return self.b_pad.device

    @property
    def nl_rows(self) -> int:
        """Columns of the nonleaf constraint dual segment e7."""
        return self.nl_lo.shape[1]

    @property
    def l_rows(self) -> int:
        """Columns of the leaf constraint dual segment e14."""
        return self.l_lo.shape[1]

    def zero_primal(self) -> Primal:
        """Zero primal on the problem's device."""
        z = dict(dtype=self.dtype, device=self.device)
        return Primal(
            x=torch.zeros((self.np_pad, self.n), **z),
            u=torch.zeros((self.nl_pad, self.m), **z),
            y=torch.zeros((self.nl_pad, self.Y), **z),
            tau=torch.zeros((self.np_pad,), **z),
            s=torch.zeros((self.np_pad,), **z),
        )

    def zero_dual(self) -> Dual:
        """Zero dual on the problem's device."""
        z = dict(dtype=self.dtype, device=self.device)
        return Dual(
            e1=torch.zeros((self.nl_pad, self.Y), **z),
            e2=torch.zeros((self.nl_pad,), **z),
            e3=torch.zeros((self.np_pad, self.n), **z),
            e4=torch.zeros((self.np_pad, self.m), **z),
            e5=torch.zeros((self.np_pad,), **z),
            e6=torch.zeros((self.np_pad,), **z),
            e7=torch.zeros((self.nl_pad, self.nl_rows), **z),
            e11=torch.zeros((self.lf_pad, self.n), **z),
            e12=torch.zeros((self.lf_pad,), **z),
            e13=torch.zeros((self.lf_pad,), **z),
            e14=torch.zeros((self.lf_pad, self.l_rows), **z),
        )


def _constraint_tables(cons, width: int):
    """Constraint-row data for one node class (nonleaf or leaf).

    Returns ``(G, lo, hi, active, ball_c, ball_r)`` where ``G`` is the
    shared Polyhedral row matrix (or None for identity-structured
    Rectangle/Ball rows) and the per-node tables have ``G.shape[0]``
    (or ``width``) columns.
    """
    from raocp_tpu_torch.core.constraints.sets import Ball, Polyhedral

    polys = [c for c in cons if isinstance(c, Polyhedral)]
    G = None
    rows = width
    if polys:
        first = polys[0]
        for p in polys:
            if p is not first and not np.array_equal(p.matrix, first.matrix):
                raise ValueError(
                    "all Polyhedral constraints of one node class must "
                    "share a single row matrix (the dual segment has one "
                    "width); use per-node bounds for node-varying sets")
        if any(c.is_active and not isinstance(c, Polyhedral) for c in cons):
            raise ValueError(
                "Polyhedral constraints cannot be mixed with active "
                "Rectangle/Ball constraints within one node class")
        G = np.asarray(first.matrix, dtype=np.float64)
        rows = first.num_rows
    count = len(cons)
    lo = np.full((count, rows), -np.inf)
    hi = np.full((count, rows), np.inf)
    active = np.zeros(count)
    ball_c = np.zeros((count, rows))
    ball_r = np.full(count, np.inf)
    for i, con in enumerate(cons):
        if con.is_active:
            active[i] = 1.0
            if isinstance(con, Ball):
                ball_c[i] = con.center_for_size(rows)
                ball_r[i] = con.radius
            else:
                lo[i] = con.min
                hi[i] = con.max
    return G, lo, hi, active, ball_c, ball_r



def _offline_riccati(spec: RAOCP, n: int, m: int):
    """Backward stage-batched Riccati-like factorisation.

    Parity: reference ``cache.py:207-233``. For each nonleaf node i (children
    ch(i)): R~_i = I + sum_j B_j'P_jB_j, K_i = -R~_i^{-1} sum_j B_j'P_jA_j,
    Abar_j = A_j + B_jK_i, P_i = I + K_i'K_i + sum_j Abar_j'P_jAbar_j.
    Additionally precomputes sumAPB_i = sum_j Abar_j'P_jB_j, used by the
    online projection.
    """
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    ns = tree.num_stages
    ss = tree.stage_start

    A = np.zeros((N, n, n))
    B = np.zeros((N, n, m))
    for j in range(1, N):
        A[j] = spec.state_dynamics_at_node(j)
        B[j] = spec.control_dynamics_at_node(j)

    P = np.zeros((N, n, n))
    P[NL:] = np.eye(n)
    K = np.zeros((NL, m, n))
    Rinv = np.zeros((NL, m, m))
    Abar = np.zeros((N, n, n))
    sumAPB = np.zeros((NL, n, m))

    # reduceat segment boundaries: children of stage-k nodes are contiguous
    cf = tree.child_first
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]          # nonleaf nodes of stage k
        a2, b2 = ss[k + 1], ss[k + 2]    # their children (all of stage k+1)
        Ac, Bc, Pc = A[a2:b2], B[a2:b2], P[a2:b2]
        seg = cf[a:b] - a2               # start of each parent's child block
        PB = Pc @ Bc                                       # [W2, n, m]
        BtPB = np.einsum("jba,jbc->jac", Bc, PB)           # [W2, m, m]
        BtPA = np.einsum("jba,jbc->jac", Bc, Pc @ Ac)      # [W2, m, n]
        sum_r = np.add.reduceat(BtPB, seg, axis=0)
        sum_k = np.add.reduceat(BtPA, seg, axis=0)
        r_tilde = np.eye(m) + sum_r
        Rinv[a:b] = np.linalg.inv(r_tilde)
        K[a:b] = np.linalg.solve(r_tilde, -sum_k)
        # expand K to children: parent of child j in [a2,b2) is anc[j]
        Kc = K[tree.ancestors[a2:b2]]
        Abar[a2:b2] = Ac + Bc @ Kc
        APB = np.einsum("jba,jbc->jac", Abar[a2:b2], PB)   # [W2, n, m]
        AtPA = np.einsum("jba,jbc,jcd->jad", Abar[a2:b2], Pc, Abar[a2:b2])
        sumAPB[a:b] = np.add.reduceat(APB, seg, axis=0)
        P[a:b] = (np.eye(n) + np.einsum("iba,ibc->iac", K[a:b], K[a:b])
                  + np.add.reduceat(AtPA, seg, axis=0))

    return A, B, P, Rinv, K, Abar, sumAPB


def _riccati_device(A, B, child_idx, child_mask, anc, stage_start,
                    num_nonleaf: int, nl_pad: int):
    """The same backward factorisation as :func:`_offline_riccati`, as an
    eager loop over stages on the tensors' device (JAX
    ``core/stacked.py:381``): only the per-mode dynamics and the index
    plans are uploaded, and the [N, n, n]-class stacks are computed where
    they are read. Returns (P, Rinv, K, Abar, sumAPB); the stage results are
    written into preallocated stacks in place."""
    ss = stage_start
    ns = len(ss) - 1
    np_pad, n = A.shape[0], A.shape[1]
    m = B.shape[2]
    NL, N = num_nonleaf, ss[ns]
    z = dict(dtype=A.dtype, device=A.device)
    eye_n = torch.eye(n, **z)
    eye_m = torch.eye(m, **z)
    P = torch.zeros((np_pad, n, n), **z)
    P[NL:N] = eye_n                                # leaves: P = I
    K = torch.zeros((nl_pad, m, n), **z)
    Rinv = torch.zeros((nl_pad, m, m), **z)
    Abar = torch.zeros((np_pad, n, n), **z)
    sumAPB = torch.zeros((nl_pad, n, m), **z)
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        Ac, Bc, Pc = A[a2:b2], B[a2:b2], P[a2:b2]
        rel = torch.clamp(child_idx[a:b] - a2, 0, b2 - a2 - 1)
        mask = child_mask[a:b][..., None, None]
        PB = Pc @ Bc                                        # [W2, n, m]
        BtPB = Bc.transpose(1, 2) @ PB
        BtPA = Bc.transpose(1, 2) @ (Pc @ Ac)
        r_tilde = eye_m + torch.sum(BtPB[rel] * mask, dim=1)
        sum_k = torch.sum(BtPA[rel] * mask, dim=1)
        Rinv_k = torch.linalg.inv(r_tilde)
        K_k = torch.linalg.solve(r_tilde, -sum_k)
        Abar_c = Ac + Bc @ K_k[anc[a2:b2] - a]
        APB = Abar_c.transpose(1, 2) @ PB
        AtPA = Abar_c.transpose(1, 2) @ Pc @ Abar_c
        P[a:b] = (eye_n + K_k.transpose(1, 2) @ K_k
                  + torch.sum(AtPA[rel] * mask, dim=1))
        K[a:b] = K_k
        Rinv[a:b] = Rinv_k
        sumAPB[a:b] = torch.sum(APB[rel] * mask, dim=1)
        Abar[a2:b2] = Abar_c
    return P, Rinv, K, Abar, sumAPB


def _offline_riccati_stage(modes_a, modes_b, patterns):
    """Backward Riccati recursion for fully stage-constant trees: one tiny
    (n x n)-class computation per stage (JAX ``core/stacked.py:573``).
    Host NumPy float64. Returns per-stage lists (P_s[ns], K_s, Rinv_s,
    sumAPB_s, Abar_s) where Abar_s[k] is [c, n, n] for stage k's
    children."""
    n = modes_a.shape[1]
    m = modes_b.shape[2]
    ns_nl = len(patterns)
    P_s = [None] * (ns_nl + 1)
    P_s[ns_nl] = np.eye(n)
    K_s, Rinv_s, APB_s, Abar_s = ([None] * ns_nl for _ in range(4))
    for k in range(ns_nl - 1, -1, -1):
        pat = patterns[k]
        Pc = P_s[k + 1]
        A = modes_a[list(pat)]          # [c, n, n]
        B = modes_b[list(pat)]          # [c, n, m]
        PB = Pc @ B                     # [c, n, m]
        r_tilde = np.eye(m) + np.einsum("rba,rbc->ac", B, PB)
        sum_k = np.einsum("rba,rbc->ac", B, Pc @ A)
        Rinv_s[k] = np.linalg.inv(r_tilde)
        K = np.linalg.solve(r_tilde, -sum_k)
        Abar = A + B @ K
        K_s[k] = K
        Abar_s[k] = Abar
        APB_s[k] = np.einsum("rba,rbc->ac", Abar, PB)
        P_s[k] = (np.eye(n) + K.T @ K
                  + np.einsum("rba,bc,rcd->ad", Abar, Pc, Abar))
    return P_s, K_s, Rinv_s, APB_s, Abar_s


def _dedup_dynamics(spec: RAOCP, n: int, m: int):
    """Distinct (A, B) pairs + per-node mode index (mode 0 = zero pair for
    the root / padding rows). Host-side, O(num_nodes) hashing."""
    tree = spec.tree
    N = tree.num_nodes
    modes_a = [np.zeros((n, n))]
    modes_b = [np.zeros((n, m))]
    seen = {}
    idx = np.zeros(N, dtype=np.int64)
    for j in range(1, N):
        a = spec.state_dynamics_at_node(j)
        b = spec.control_dynamics_at_node(j)
        key = id(a)            # Markovian specs share mode objects
        if key not in seen:
            bkey = (a.tobytes(), b.tobytes())
            if bkey in seen:
                seen[key] = seen[bkey]
            else:
                seen[key] = seen[bkey] = len(modes_a)
                modes_a.append(np.asarray(a, dtype=np.float64))
                modes_b.append(np.asarray(b, dtype=np.float64))
        idx[j] = seen[key]
    return np.stack(modes_a), np.stack(modes_b), idx



def _offline_kernel_projectors(spec: RAOCP, d_max: int,
                               y_dim: int) -> np.ndarray:
    """Orthogonal projectors onto ker([[E', -I, -I], [F', 0, 0]]) in the
    padded [y | tau | s] layout (parity: reference ``cache.py:235-242``,
    with lstsq-per-iteration replaced by a precomputed projector)."""
    tree = spec.tree
    NL = tree.num_nonleaf_nodes
    Y = y_dim
    D = Y + 2 * d_max
    Pi = np.zeros((NL, D, D))
    cache = {}
    for i in range(NL):
        risk = spec.risk_at_node(i)
        E, F = risk.matrix_e, risk.matrix_f
        c = tree.child_count[i]
        key = (E.shape, E.tobytes(), F.shape, F.tobytes(), int(c))
        if key not in cache:
            eye = np.eye(c)
            zeros = np.zeros((F.shape[1], c))
            M = np.vstack((np.hstack((E.T, -eye, -eye)),
                           np.hstack((F.T, zeros, zeros))))
            # Pi_small = I - M'(MM')^+ M  (pinv guards rank deficiency;
            # equals the reference's null-space projector)
            MMt_inv = np.linalg.pinv(M @ M.T)
            Pi_small = np.eye(M.shape[1]) - M.T @ MMt_inv @ M
            # embed unpadded coords [y(R), tau(c), s(c)] into the padded
            # layout: y rows -> slots [0, R), tau_j -> Y+j, s_j -> Y+d+j
            R = E.shape[0]
            emb = np.concatenate((
                np.arange(R),
                Y + np.arange(c),
                Y + d_max + np.arange(c)))
            Pi_pad = np.zeros((D, D))
            Pi_pad[np.ix_(emb, emb)] = Pi_small
            cache[key] = Pi_pad
        Pi[i] = cache[key]
    return Pi


def _cone_row_kinds(cone, rows: int):
    """Row-kind codes of a risk cone: 0 = NnOC (dual: max(0, .)),
    1 = Zero (dual: identity), 2 = Real (dual: zero map), 3 = SOC member
    rows, 4 = the SOC radial (last) row. Any Cartesian product of NnOC /
    Zero / Real components plus AT MOST ONE SecondOrderCone block batches
    branch-free via per-row masks (the SOC block projects jointly, driven
    by the kind-3/kind-4 masks — see ops.cones.risk_dual_project)."""
    import raocp_tpu_torch.core.constraints.cones as cones

    comps = cone.cones if isinstance(cone, cones.Cartesian) else [cone]
    kinds = []
    soc_seen = False
    for comp in comps:
        dim = comp.dimension
        if dim is None:
            raise ValueError("risk cone components must carry explicit "
                             "dimensions")
        if isinstance(comp, cones.NonnegativeOrthant):
            kinds.extend([0] * dim)
        elif isinstance(comp, cones.Zero):
            kinds.extend([1] * dim)
        elif isinstance(comp, cones.Real):
            kinds.extend([2] * dim)
        elif isinstance(comp, cones.SecondOrderCone):
            if soc_seen:
                raise NotImplementedError(
                    "a risk cone may contain at most one SecondOrderCone "
                    "block (one joint projection per node)")
            if dim < 2:
                raise ValueError("a SecondOrderCone block needs at least "
                                 "2 rows (members + radial)")
            soc_seen = True
            kinds.extend([3] * (dim - 1) + [4])
        else:
            raise NotImplementedError(
                "risk cones must be Cartesian products of "
                "NonnegativeOrthant / Zero / Real / SecondOrderCone "
                f"components; got {type(comp).__name__}")
    if len(kinds) != rows:
        raise ValueError(f"risk cone dimension {len(kinds)} does not match "
                         f"the {rows} rows of (E, b)")
    return kinds



def _riccati_plan(w_idx: np.ndarray, stage_start, stage_child, ab_pat):
    """Backward classification of nonleaf stages for table-based Riccati:

    * ``("const", pattern)`` — uniform child-mode pattern AND a
      table-compatible child stage: every node of the stage shares one
      (P, K, Rinv, sumAPB).
    * ``("modal", cls)`` — chain stage (uniform single child) whose
      per-node subtree is classed by the child's mode (a stopped Markov
      chain: the chain copies the mode forever), so the tables take at
      most num_modes distinct values, indexed by ``cls``.
    * ``None`` — dense fallback; table validity is a suffix property, so
      every stage above a None is None too.
    """
    ns_nl = len(stage_child)
    plan = [None] * ns_nl
    below_kind, below_cls = "I", None
    for k in range(ns_nl - 1, -1, -1):
        a2, b2 = stage_start[k + 1], stage_start[k + 2]
        child_modes = w_idx[a2:b2]
        # a modal child stage is consumable iff each child's class equals
        # its own mode (true exactly when the chain repeats the mode)
        ok_below = below_kind != "modal" or bool(
            np.array_equal(below_cls, child_modes))
        if ab_pat[k] is not None and ok_below:
            plan[k] = ("const", ab_pat[k])
            below_kind, below_cls = "const", None
        elif stage_child[k] == 1 and ok_below:
            cls = child_modes.astype(np.int64)
            plan[k] = ("modal", cls)
            below_kind, below_cls = "modal", cls
        else:
            break
    return plan


def _offline_riccati_tables(modes_a, modes_b, plan):
    """Backward Riccati recursion over the table plan: one tiny matrix per
    ("const") stage, one [num_modes, ...] table per ("modal") chain stage.
    Host numpy float64; replaces the [N, n, n]-class dense stacks for any
    stopped Markov tree. Returns per-stage lists
    (K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms), None where not that kind.
    """
    n, m = modes_a.shape[1], modes_b.shape[2]
    M = modes_a.shape[0]
    ns_nl = len(plan)
    eye_n, eye_m = np.eye(n), np.eye(m)
    K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms = (
        [None] * ns_nl for _ in range(6))
    P_rep = ("I", eye_n)
    for k in range(ns_nl - 1, -1, -1):
        if plan[k] is None:
            break
        kind, data = plan[k]
        if kind == "const":
            pat = list(data)
            A = modes_a[pat]
            B = modes_b[pat]
            if P_rep[0] == "modal":
                Pc = P_rep[1][pat]                       # [c, n, n]
            else:
                Pc = np.broadcast_to(P_rep[1], (len(pat), n, n))
            PB = Pc @ B
            r_tilde = eye_m + np.einsum("rba,rbc->ac", B, PB)
            sum_k = np.einsum("rba,rbc->ac", B, Pc @ A)
            Rinv_s[k] = np.linalg.inv(r_tilde)
            K = np.linalg.solve(r_tilde, -sum_k)
            Abar = A + B @ K
            K_s[k] = K
            APB_s[k] = np.einsum("rba,rbc->ac", Abar, PB)
            P_rep = ("const",
                     eye_n + K.T @ K
                     + np.einsum("rba,rbc,rcd->ad", Abar, Pc, Abar))
        else:                                            # modal chain stage
            cls = data
            Pm = np.zeros((M, n, n))
            Km = np.zeros((M, m, n))
            Rm = np.zeros((M, m, m))
            APBm = np.zeros((M, n, m))
            for w in np.unique(cls):
                A, B = modes_a[w], modes_b[w]
                Pc = P_rep[1][w] if P_rep[0] == "modal" else P_rep[1]
                PB = Pc @ B
                r_tilde = eye_m + B.T @ PB
                Rm[w] = np.linalg.inv(r_tilde)
                K = np.linalg.solve(r_tilde, -(B.T @ Pc @ A))
                Abar = A + B @ K
                Km[w] = K
                APBm[w] = Abar.T @ PB
                Pm[w] = eye_n + K.T @ K + Abar.T @ Pc @ Abar
            K_ms[k], Rinv_ms[k], APB_ms[k] = Km, Rm, APBm
            P_rep = ("modal", Pm)
    return K_s, Rinv_s, APB_s, K_ms, Rinv_ms, APB_ms


def _stage_mode_patterns(idx: np.ndarray, stage_start, stage_child):
    """Per nonleaf stage: the child mode sequence (tuple of mode ids, length
    c) when it is identical for every parent in the stage, else None."""
    pats = []
    for k in range(len(stage_child)):
        c = stage_child[k]
        a2, b2 = stage_start[k + 1], stage_start[k + 2]
        if c is None:
            pats.append(None)
            continue
        blk = idx[a2:b2].reshape(-1, c)
        pats.append(tuple(int(v) for v in blk[0])
                    if (blk == blk[0]).all() else None)
    return tuple(pats)


def _pad0(arr: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of a numpy array to ``rows`` with ``fill``."""
    extra = rows - arr.shape[0]
    if extra == 0:
        return arr
    pad = np.full((extra,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)




def _fuse_block_diag(mq: ModalMatrix, mr: ModalMatrix, dtype,
                     device) -> Optional[ModalMatrix]:
    """Mode-grouped blockdiag(Q_j, R_j) from two mode-grouped stacks over
    the same node space. Joint modes come from unique (q, r) index pairs;
    returns None when either stack is dense or the joint mode count exceeds
    the modal limit (callers then use the unfused pair). Like the JAX
    package, the joint modes are built from the modes as stored (in the
    working dtype)."""
    if mq.modes is None or mr.modes is None:
        return None
    qi = mq.idx.cpu().numpy()
    ri = mr.idx.cpu().numpy()
    pairs = qi * mr.modes.shape[0] + ri
    uniq, inv = np.unique(pairs, return_inverse=True)
    if len(uniq) > MODAL_MAX_MODES:
        return None
    qm = mq.modes.cpu().double().numpy()
    rm = mr.modes.cpu().double().numpy()
    nq, nr = qm.shape[1], rm.shape[1]
    modes = np.zeros((len(uniq), nq + nr, nq + nr))
    for t, p in enumerate(uniq):
        a, b = divmod(int(p), rm.shape[0])
        modes[t, :nq, :nq] = qm[a]
        modes[t, nq:, nq:] = rm[b]
    return ModalMatrix(
        dense_m=None,
        modes=upload(modes, dtype, device),
        idx=upload(inv.reshape(-1).astype(np.int64), device=device))


def _stacked_stage_weights(mm: Optional[ModalMatrix], patterns, dtype,
                           device):
    """(fwd, bwd) tuples of per-stage stacked mode blocks for a mode-grouped
    matrix: fwd[k] [in, c, out] (children-from-parents), bwd[k]
    [c, in, out] (rmatvec summed over children in one contraction over
    (c, in)). One shared tensor per distinct pattern, so consecutive stages
    with identical blocks group by identity (ops.operator.stage_groups)."""
    if mm is None or mm.modes is None:
        none = tuple(None for _ in patterns)
        return none, none
    modes = mm.modes.cpu().double().numpy()
    fwd, bwd = [], []
    cache = {}
    for pat in patterns:
        if pat is None:
            fwd.append(None)
            bwd.append(None)
        else:
            if pat not in cache:
                cache[pat] = (
                    upload(np.stack([modes[p].T for p in pat], axis=1),
                           dtype, device),
                    upload(np.stack([modes[p] for p in pat], axis=0),
                           dtype, device))
            f, b = cache[pat]
            fwd.append(f)
            bwd.append(b)
    return tuple(fwd), tuple(bwd)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, NumPy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU (reference parity), float32 on a GPU (the
    working precision of the card)."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def build_stacked(spec: RAOCP, dtype=None, pad_multiple: int = 1,
                  offline: str = "host", keep_dense: bool = False,
                  device="cuda") -> StackedProblem:
    """Materialise a :class:`StackedProblem` on ``device`` (the card by
    default; pass ``device="cpu"`` for the CPU).

    ``dtype`` defaults to float64 on the CPU and float32 on a GPU
    (:func:`default_dtype`). ``pad_multiple`` pads each node space
    (all-node / nonleaf / leaf) to a multiple of this; ghost rows are zero
    (bounds: +-inf) and stay zero through every operator and prox map.

    The Riccati-like factorisation, in the JAX package's branch order:

    * a fully tabled tree without ``keep_dense``: on the host in float64
      NumPy over one tiny matrix per stage (per mode on chain stages),
      whatever ``offline`` says; only the tables reach the device;
    * ``offline="device"``: on ``device`` in ``dtype`` — the stage tables
      broadcast to dense stacks on a fully stage-constant tree with
      ``keep_dense``, else :func:`_riccati_device` over the dense stacks;
    * ``offline="host"``: on the host in float64 over the dense per-node
      stacks.

    ``keep_dense`` forces the dense stacks (A/B/P/Rinv/K/Abar/sumAPB) onto
    the device.
    """
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    if offline not in ("host", "device"):
        raise ValueError(f"offline must be 'host' or 'device', got {offline}")
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    LF = N - NL
    n = spec.state_size
    m = spec.control_size
    d = tree.max_branching
    # padded y width: the max row count of any node's risk matrix E
    Y = max(spec.risk_at_node(i).matrix_e.shape[0] for i in range(NL))

    def up(v: int) -> int:
        return -(-v // pad_multiple) * pad_multiple

    NP_, NLP, LFP = up(N), up(NL), up(LF)

    def dev(x, dt=dtype):
        return upload(x, dt, device)

    def dev_idx(x):
        return dev(np.asarray(x, dtype=np.int64), torch.int64)

    Pi = _offline_kernel_projectors(spec, d, Y)

    def modal_stack(fetch, start: int, stop: int, offset: int, rows: int,
                    shape):
        """Mode-grouped stack from per-node matrices without materialising
        the dense [rows, *shape] array (id()-keyed dedup, content hashing
        as fallback). Node ``j`` lands in row ``j - offset``; mode 0 is the
        zero matrix (unassigned/padded rows)."""
        modes = [np.zeros(shape)]
        seen: dict = {}
        idx = np.zeros(rows, dtype=np.int64)
        dense = False
        for j in range(start, stop):
            mat = fetch(j)
            key = id(mat)
            mode = seen.get(key)
            if mode is None:
                bkey = mat.tobytes()
                mode = seen.get(bkey)
                if mode is None:
                    mode = len(modes)
                    modes.append(np.asarray(mat, dtype=np.float64))
                seen[key] = seen[bkey] = mode
            idx[j - offset] = mode
            if len(modes) > MODAL_MAX_MODES:
                dense = True
                break
        if dense:                                   # too many modes
            stack = np.zeros((rows,) + shape)
            for j in range(start, stop):
                stack[j - offset] = fetch(j)
            return from_dense_stack(stack, dtype, device)
        return ModalMatrix(dense_m=None, modes=dev(np.stack(modes)),
                           idx=dev_idx(idx))

    sqrtQ_m = modal_stack(
        lambda j: spec.nonleaf_cost_at_node(j).sqrt_state_weights,
        1, N, 0, NP_, (n, n))
    sqrtR_m = modal_stack(
        lambda j: spec.nonleaf_cost_at_node(j).sqrt_control_weights,
        1, N, 0, NP_, (m, m))
    sqrtP_m = modal_stack(
        lambda i: spec.leaf_cost_at_node(i).sqrt_state_weights,
        NL, N, NL, LFP, (n, n))

    # risk b vectors + row-kind masks in the padded layout
    b_pad = np.zeros((NL, Y))
    y_mask = np.zeros((NL, Y))
    risk_free = np.zeros((NL, Y), dtype=bool)   # Zero-cone rows
    risk_zero = np.zeros((NL, Y), dtype=bool)   # Real-cone rows
    risk_soc = np.zeros((NL, Y), dtype=bool)    # SOC member rows
    risk_soc_t = np.zeros((NL, Y), dtype=bool)  # SOC radial rows
    for i in range(NL):
        risk = spec.risk_at_node(i)
        b = risk.vector_b.reshape(-1)
        R = b.size
        b_pad[i, :R] = b
        y_mask[i, :R] = 1.0
        kinds = np.asarray(_cone_row_kinds(risk.cone, R))
        risk_free[i, :R] = kinds == 1
        risk_zero[i, :R] = kinds == 2
        risk_soc[i, :R] = kinds == 3
        risk_soc_t[i, :R] = kinds == 4
    has_soc = bool(risk_soc_t.any())

    nl_G, nl_lo, nl_hi, nl_active, nl_ball_c, nl_ball_r = _constraint_tables(
        [spec.nonleaf_constraint_at_node(i) for i in range(NL)], n + m)
    l_G, l_lo, l_hi, l_active, l_ball_c, l_ball_r = _constraint_tables(
        [spec.leaf_constraint_at_node(i) for i in range(NL, N)], n)

    anc = tree.ancestors.copy()
    anc[0] = 0
    nz_mask = np.ones(N)
    nz_mask[0] = 0.0

    stage_start = tuple(int(v) for v in tree.stage_start)
    stage_child = tree.stage_child
    anc_dev = dev_idx(_pad0(anc, NP_))
    child_idx_dev = dev_idx(_pad0(tree.children_padded, NLP))
    child_mask_dev = dev(_pad0(tree.children_mask.astype(np.float64), NLP))

    modes_a, modes_b, w_idx = _dedup_dynamics(spec, n, m)
    idx_dev = dev_idx(_pad0(w_idx, NP_))             # pad rows -> zero mode
    Am = ModalMatrix(dense_m=None, modes=dev(modes_a), idx=idx_dev)
    Bm = ModalMatrix(dense_m=None, modes=dev(modes_b), idx=idx_dev)
    ABm = ModalMatrix(dense_m=None,
                      modes=dev(np.concatenate([modes_a, modes_b], axis=2)),
                      idx=idx_dev)
    QRm = _fuse_block_diag(sqrtQ_m, sqrtR_m, dtype, device)

    ab_pat = _stage_mode_patterns(w_idx, stage_start, stage_child)
    ab_fwd, ab_bwd = _stacked_stage_weights(ABm, ab_pat, dtype, device)
    # stage-constant at stage k iff every stage from k to the leaves has a
    # uniform mode pattern (induction from P = I at the leaves)
    ns_nl = len(stage_child)
    stage_const = [False] * ns_nl
    const_below = True
    for k in range(ns_nl - 1, -1, -1):
        const_below = const_below and (ab_pat[k] is not None)
        stage_const[k] = const_below
    if QRm is not None:
        qr_pat = _stage_mode_patterns(QRm.idx.cpu().numpy()[:N],
                                      stage_start, stage_child)
        qr_fwd, qr_bwd = _stacked_stage_weights(QRm, qr_pat, dtype, device)
    else:
        qr_fwd = qr_bwd = tuple(None for _ in stage_child)

    # K/Rinv/sumAPB stacks are read only on stages with neither stage- nor
    # mode-constant tables; A/B/P/Abar never
    fully_const = bool(ns_nl) and stage_const[0]
    plan = _riccati_plan(w_idx, stage_start, stage_child, ab_pat)
    fully_tabled = bool(ns_nl) and plan[0] is not None
    need_kr = keep_dense or not fully_tabled

    A_dev = B_dev = P_dev = Rinv_dev = K_dev = None
    Abar_dev = sumAPB_dev = None
    k_s = rinv_s = sumapb_s = None
    k_ms = rinv_ms = sumapb_ms = None
    riccati_cls = None

    if fully_tabled and not keep_dense:
        # host-table branch: one tiny matrix per stage (per mode on chain
        # stages), float64; only the tables reach the device
        K_sl, Rinv_sl, APB_sl, K_msl, Rinv_msl, APB_msl = \
            _offline_riccati_tables(modes_a, modes_b, plan)

        def opt(tabs):
            return tuple(None if t is None else dev(t) for t in tabs)

        k_s, rinv_s, sumapb_s = opt(K_sl), opt(Rinv_sl), opt(APB_sl)
        k_ms, rinv_ms, sumapb_ms = opt(K_msl), opt(Rinv_msl), opt(APB_msl)
        if any(t is not None for t in k_ms):
            cls = np.zeros(NP_, dtype=np.int64)
            for k in range(ns_nl):
                if plan[k] is not None and plan[k][0] == "modal":
                    cls[stage_start[k]:stage_start[k + 1]] = plan[k][1]
            riccati_cls = dev_idx(cls)
    elif offline == "device":
        A_dev, B_dev = Am.modes[idx_dev], Bm.modes[idx_dev]
        if fully_const:
            # keep_dense on a fully stage-constant tree: the stage tables,
            # broadcast to the dense stacks on the device
            P_sl, K_sl, Rinv_sl, APB_sl, Abar_sl = _offline_riccati_stage(
                modes_a, modes_b, ab_pat)
            widths = [stage_start[k + 1] - stage_start[k]
                      for k in range(tree.num_stages)]

            def bcast(tabs, rows, pad_rows):
                parts = [dev(t).expand((w,) + t.shape)
                         for t, w in zip(tabs, rows)]
                parts.append(torch.zeros((pad_rows,) + tabs[0].shape,
                                         dtype=dtype, device=device))
                return torch.cat(parts, dim=0)

            P_dev = bcast(P_sl, widths, NP_ - N)
            K_dev = bcast(K_sl, widths[:-1], NLP - NL)
            Rinv_dev = bcast(Rinv_sl, widths[:-1], NLP - NL)
            sumAPB_dev = bcast(APB_sl, widths[:-1], NLP - NL)
            ab_parts = [torch.zeros((1, n, n), dtype=dtype, device=device)]
            for k, ab in enumerate(Abar_sl):      # [c, n, n] per parent
                ab_parts.append(dev(ab).expand((widths[k],) + ab.shape)
                                .reshape(-1, n, n))
            ab_parts.append(torch.zeros((NP_ - N, n, n), dtype=dtype,
                                        device=device))
            Abar_dev = torch.cat(ab_parts, dim=0)
        else:
            P_dev, Rinv_dev, K_dev, Abar_dev, sumAPB_dev = _riccati_device(
                A_dev, B_dev, child_idx_dev, child_mask_dev, anc_dev,
                stage_start, NL, NLP)
            if not keep_dense:   # transient inputs and outputs
                A_dev = B_dev = P_dev = Abar_dev = None
    else:
        # host-dense branch: the per-node factorisation over dense stacks
        A, B, P, Rinv, K, Abar, sumAPB = _offline_riccati(spec, n, m)
        if keep_dense:
            A_dev, B_dev = dev(_pad0(A, NP_)), dev(_pad0(B, NP_))
            P_dev = dev(_pad0(P, NP_))
            Abar_dev = dev(_pad0(Abar, NP_))
        Rinv_dev, K_dev = dev(_pad0(Rinv, NLP)), dev(_pad0(K, NLP))
        sumAPB_dev = dev(_pad0(sumAPB, NLP))

    if k_s is None:
        # representative rows for stage-constant stages (first node of stage)
        k_s = tuple(K_dev[stage_start[k]] if stage_const[k] else None
                    for k in range(ns_nl))
        rinv_s = tuple(Rinv_dev[stage_start[k]] if stage_const[k] else None
                       for k in range(ns_nl))
        sumapb_s = tuple(sumAPB_dev[stage_start[k]] if stage_const[k]
                         else None for k in range(ns_nl))
    if k_ms is None:
        k_ms = rinv_ms = sumapb_ms = tuple(None for _ in range(ns_nl))
    if not need_kr:
        Rinv_dev = K_dev = sumAPB_dev = None

    return StackedProblem(
        n=n, m=m, num_nodes=N, num_nonleaf=NL, num_leaf=LF,
        d_max=d, num_stages=tree.num_stages,
        stage_start=stage_start,
        stage_child=stage_child,
        np_pad=NP_, nl_pad=NLP, lf_pad=LFP, y_dim=Y,
        anc=anc_dev,
        child_idx=child_idx_dev,
        child_mask=child_mask_dev,
        child_rank=dev_idx(_pad0(tree.child_rank, NP_)),
        nz_mask=dev(_pad0(nz_mask, NP_)),
        risk_free_rows=dev(_pad0(risk_free, NLP), torch.bool),
        risk_zero_rows=dev(_pad0(risk_zero, NLP), torch.bool),
        risk_soc_rows=(dev(_pad0(risk_soc, NLP), torch.bool) if has_soc
                       else None),
        risk_soc_tail=(dev(_pad0(risk_soc_t, NLP), torch.bool) if has_soc
                       else None),
        A=A_dev, B=B_dev, Am=Am, Bm=Bm, ABm=ABm,
        sqrtQ=sqrtQ_m, sqrtR=sqrtR_m, QRm=QRm, sqrtP=sqrtP_m,
        ab_fwd=ab_fwd, ab_bwd=ab_bwd, qr_fwd=qr_fwd, qr_bwd=qr_bwd,
        k_s=k_s, rinv_s=rinv_s, sumapb_s=sumapb_s,
        k_ms=k_ms, rinv_ms=rinv_ms, sumapb_ms=sumapb_ms,
        riccati_cls=riccati_cls,
        b_pad=dev(_pad0(b_pad, NLP)), y_mask=dev(_pad0(y_mask, NLP)),
        nl_lo=dev(_pad0(nl_lo, NLP, -np.inf)),
        nl_hi=dev(_pad0(nl_hi, NLP, np.inf)),
        nl_active=dev(_pad0(nl_active, NLP)),
        nl_ball_c=dev(_pad0(nl_ball_c, NLP)),
        nl_ball_r=dev(_pad0(nl_ball_r, NLP, np.inf)),
        l_lo=dev(_pad0(l_lo, LFP, -np.inf)),
        l_hi=dev(_pad0(l_hi, LFP, np.inf)),
        l_active=dev(_pad0(l_active, LFP)),
        l_ball_c=dev(_pad0(l_ball_c, LFP)),
        l_ball_r=dev(_pad0(l_ball_r, LFP, np.inf)),
        nl_G=None if nl_G is None else dev(nl_G),
        l_G=None if l_G is None else dev(l_G),
        P=P_dev, Rinv=Rinv_dev, K=K_dev, Abar=Abar_dev,
        sumAPB=sumAPB_dev, Pi=dev(_pad0(Pi, NLP)),
    )


# -- carrying a stacked problem across packages ------------------------------

def _host(v):
    """NumPy view of a torch tensor (any device) or any array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def to_numpy(sp):
    """``(leaves, static)`` NumPy dicts of a stacked problem, from this
    package's :class:`StackedProblem` or from the JAX package's one (read
    field by field, so this module needs no JAX import). Leaves are
    arrays or None; per-stage fields are tuples of those; mode-grouped
    fields are dicts with keys ``dense_m`` / ``modes`` / ``idx``."""
    leaves, static = {}, {}
    for f in dataclasses.fields(sp):
        v = getattr(sp, f.name)
        if f.name in STATIC_FIELDS or not (
                v is None or isinstance(v, tuple) or hasattr(v, "shape")
                or hasattr(v, "modes")):
            static[f.name] = v
        elif v is None:
            leaves[f.name] = None
        elif isinstance(v, tuple):
            leaves[f.name] = tuple(None if t is None else _host(t) for t in v)
        elif hasattr(v, "modes"):
            leaves[f.name] = {k: None if getattr(v, k) is None
                              else _host(getattr(v, k))
                              for k in ("dense_m", "modes", "idx")}
        else:
            leaves[f.name] = _host(v)
    return leaves, static


def from_numpy(leaves: dict, static: dict, device="cuda",
               dtype=None) -> StackedProblem:
    """Build a :class:`StackedProblem` from :func:`to_numpy`'s dicts (for
    example of a problem stacked by the JAX package). Float leaves become
    ``dtype`` tensors on ``device``, integer leaves ``int64``, bool leaves
    stay bool. Identical per-stage blocks share one tensor, so the
    stage-grouped contractions group as in :func:`build_stacked`. A
    partitioned problem (``frontier`` or an SPMD field set) is refused: it
    holds one device's block, so carry the global problem and partition it
    with :func:`raocp_tpu_torch.parallel.build_subtree_problem`."""
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    names = {f.name for f in dataclasses.fields(StackedProblem)}

    def conv(a):
        if a is None:
            return None
        a = np.array(a, order="C")   # a writable copy (JAX arrays are not)
        if a.dtype == np.bool_:
            return upload(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return upload(a.astype(np.int64), device=device)
        return upload(a, dtype, device)

    kw = {}
    for name, v in static.items():
        if name in ("frontier", "spmd_axis", "spmd_group", "spmd_ndev",
                    "flat") and v is not None:
            raise ValueError(
                f"static field {name}={v!r}: a partitioned problem cannot be "
                "carried across; carry the global problem and partition it "
                "with raocp_tpu_torch.parallel.build_subtree_problem")
        if name in names:
            kw[name] = tuple(v) if isinstance(v, (list, tuple)) else v
        elif v is not None:
            raise ValueError(f"unknown stacked-problem static field '{name}'")
    for name, v in leaves.items():
        if name not in names:
            if v is not None:
                raise ValueError(f"unknown stacked-problem leaf '{name}'")
            continue
        if name in MODAL_FIELDS:
            kw[name] = None if v is None else ModalMatrix(
                dense_m=conv(v["dense_m"]), modes=conv(v["modes"]),
                idx=conv(v["idx"]))
        elif name in STAGE_FIELDS:
            interned = {}
            out = []
            for t in v:
                if t is None:
                    out.append(None)
                    continue
                t = np.asarray(t)
                key = (t.shape, t.tobytes())
                if key not in interned:
                    interned[key] = conv(t)
                out.append(interned[key])
            kw[name] = tuple(out)
        else:
            kw[name] = conv(v)
    return StackedProblem(**kw)
