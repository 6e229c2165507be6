"""The work of each component of the Chambolle-Pock step, counted from the
shapes of a :class:`StackedProblem` (counterpart of the JAX package's
``scripts/roofline.py`` ``_cost``, which reads XLA's cost model; PyTorch
has none, and XLA's byte counts are every operand of every fused op, not
the traffic a component needs).

Each function returns a dict:

* ``flop_mm``: the contractions the port runs, 2 M N K each (a
  mode-grouped matvec computes all of its M modes and then selects, so it
  counts M times the selected product). ``torch.utils.flop_counter``
  counts the same on the CPU.
* ``flop_ew``: the elementwise work, by this rule: one operation per
  element for each add, subtract, multiply, divide, negation, square root,
  minimum or maximum in the port's expressions, and one per element a sum
  or max reduction reads; selects, comparisons, copies, concatenations,
  pads, gathers and scatters count none. Rows are the padded rows the port
  computes on.
* ``flop``: the two together.
* ``bytes``: the compulsory traffic: every tensor the component reads from
  outside read once (the problem's tables each once, however many stages
  share them, and an input leaf that is another leaf, such as ``L z``'s
  e1, which is z's y, once), and every tensor it returns written once (a
  returned input, or a tensor returned twice, such as ``L z``'s e5 and e6,
  once or not at all). A composite (``prox_f``, the step, the iteration,
  the production trip) gets its own count, as if it ran as one kernel;
  ``bytes_unfused`` beside it is the sum of its parts' counts.

The iterates carry no lane axis here. :func:`project_dynamics` is K1's
count (:func:`raocp_tpu_torch.ops.sweep.sweep_work`: the real rows of x
and u, each stage's weights as the kernel stores them) where the problem
takes K1, and the stage path's otherwise.

The card's peaks live here and only here (NVIDIA H100 SXM data sheet, at
the full 700 W limit): ``PEAK_BYTES`` of device memory a second;
``PEAK_FLOPS`` for products, by element size: float32 runs them on the FMA
units outside the tensor cores (67 TFLOP/s), float64 on the tensor cores'
DMMA, which rounds as fma does and so is open to a hand-written kernel
(67 TFLOP/s, twice the FMA units' 34); ``PEAK_VECTOR_FLOPS`` for the
elementwise work, which runs on the FMA units in both types (67 and 34
TFLOP/s). :func:`bound` turns a count into the least time the card could
take for it.
"""

import math

import torch

from raocp_tpu_torch.core.variables import dual_shapes, primal_shapes
from raocp_tpu_torch.ops.operator import (_same_child, _same_weight,
                                          stage_groups)
from raocp_tpu_torch.ops.sweep import _esize, sweep_eligible, sweep_work

__all__ = ["PEAK_FLOPS", "PEAK_VECTOR_FLOPS", "PEAK_BYTES", "bound", "ell",
           "ell_t", "project_dynamics", "project_dynamics_stages",
           "project_kernel", "prox_f", "g_conj_projections", "dual_update",
           "over_relax", "max_norm", "cp_step", "cp_iteration",
           "production_trip"]

PEAK_FLOPS = {4: 67e12, 8: 67e12}
PEAK_VECTOR_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12

# the leaves of L z that are other tensors (e1 is z's y) or one tensor
# twice (e5 and e6, e12 and e13): read and written once
_LZ_REPEATS = ("e1", "e6", "e13")


def bound(work: dict, dtype) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for ``work`` in ``dtype``: the larger of its bytes over the
    memory rate and its operations over their peak rates. In float32 the
    products and the elementwise work share the FMA units, so their times
    add; in float64 the products may run on the tensor cores beside them."""
    esize = _esize(dtype)
    mm, ew = work.get("flop_mm", work["flop"]), work.get("flop_ew", 0)
    if esize == 4:
        ops = (mm + ew) / PEAK_FLOPS[4]
    else:
        ops = max(mm / PEAK_FLOPS[esize], ew / PEAK_VECTOR_FLOPS[esize])
    by = {"bytes": work["bytes"] / PEAK_BYTES, "operations": ops}
    key = max(by, key=by.get)
    return by[key], key


class _Tally:
    """Operations and the distinct tables of one component."""

    def __init__(self):
        self.mm = 0
        self.ew = 0
        self.tables = {}

    def table(self, *tensors):
        for t in tensors:
            if t is not None and t.numel():
                self.tables[t.untyped_storage().data_ptr()] = \
                    t.numel() * t.element_size()

    def modal(self, mat, rows):
        """A mode-grouped matvec (or its transpose) on ``rows`` rows."""
        if mat.dense_m is not None:
            a, b = mat.dense_m.shape[-2:]
            self.table(mat.dense_m)
            self.mm += 2 * rows * a * b
            return
        modes, a, b = mat.modes.shape
        self.table(mat.modes)
        if modes > 1:
            self.table(mat.idx)
        self.mm += 2 * rows * a * b * modes

    def add(self, other):
        self.mm += other.mm
        self.ew += other.ew
        self.tables.update(other.tables)
        return self

    def bytes(self):
        return sum(self.tables.values())


def _leaves(shapes, skip=()):
    """Elements of the leaves of a primal or dual shape tuple."""
    return sum(math.prod(s) for name, s in zip(shapes._fields, shapes)
               if name not in skip)


def _stage(sp, k):
    ss = sp.stage_start
    return ss[k], ss[k + 1], ss[k + 1], ss[k + 2]


def _child_sums(t, sp, width):
    """:func:`raocp_tpu_torch.ops.operator.sum_over_children` of a
    [np_pad, width] table."""
    ss = sp.stage_start
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        if sp.stage_child[k0] is not None:
            t.ew += (ss[k1 + 1] - ss[k0 + 1]) * width
        else:
            t.table(sp.child_idx, sp.child_mask)
            t.ew += 2 * (ss[k1] - ss[k0]) * sp.d_max * width


def _parent_expand(t, sp):
    for k0, _ in stage_groups(sp, _same_child(sp)):
        if sp.stage_child[k0] is None:
            t.table(sp.anc)


def _ell(sp):
    t = _Tally()
    n, m = sp.n, sp.m
    F = n + m
    nl, npd, lf, Y = sp.nl_pad, sp.np_pad, sp.lf_pad, sp.Y
    ss = sp.stage_start
    t.table(sp.b_pad)
    t.ew += 2 * nl * Y + nl                   # e2 = s - sum(b * y)
    if sp.QRm is not None and any(w is not None for w in sp.qr_fwd):
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_fwd)):
            a, b, a2, b2 = ss[k0], ss[k1], ss[k0 + 1], ss[k1 + 1]
            w = sp.qr_fwd[k0]
            if w is not None:
                t.table(w)
                t.mm += 2 * (b - a) * F * w.shape[1] * F
            else:
                if sp.stage_child[k0] is None:
                    t.table(sp.anc)
                t.modal(sp.QRm, b2 - a2)
    elif sp.QRm is not None:
        _parent_expand(t, sp)
        t.modal(sp.QRm, npd)
    else:
        _parent_expand(t, sp)
        t.modal(sp.sqrtQ, npd)
        t.modal(sp.sqrtR, npd)
    t.table(sp.nz_mask)
    t.ew += 2 * npd                            # tau / 2 on real children
    if sp.nl_G is not None:
        t.table(sp.nl_G)
        t.mm += 2 * nl * F * sp.nl_rows
    t.table(sp.nl_active)
    t.ew += nl * sp.nl_rows
    t.modal(sp.sqrtP, lf)
    t.ew += lf                                 # s_leaf / 2
    if sp.l_G is not None:
        t.table(sp.l_G)
        t.mm += 2 * lf * n * sp.l_rows
    t.table(sp.l_active)
    t.ew += lf * sp.l_rows
    return t


def _ell_t(sp):
    t = _Tally()
    n, m = sp.n, sp.m
    F = n + m
    nl, npd, lf, Y = sp.nl_pad, sp.np_pad, sp.lf_pad, sp.Y
    ss = sp.stage_start
    t.table(sp.b_pad)
    t.ew += 2 * nl * Y                         # y = e1 - b e2
    t.table(sp.nl_active)
    t.ew += nl * sp.nl_rows
    if sp.nl_G is not None:
        t.table(sp.nl_G)
        t.mm += 2 * nl * sp.nl_rows * F
    if sp.QRm is not None and any(w is not None for w in sp.qr_bwd):
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_bwd)):
            a, b, a2, b2 = ss[k0], ss[k1], ss[k0 + 1], ss[k1 + 1]
            w = sp.qr_bwd[k0]
            if w is not None:
                t.table(w)
                t.mm += 2 * (b - a) * w.shape[0] * F * F
                continue
            t.modal(sp.QRm, b2 - a2)
            if sp.stage_child[k0] is not None:
                t.ew += (b2 - a2) * F
            else:
                t.table(sp.child_idx, sp.child_mask)
                t.ew += 2 * (b - a) * sp.d_max * F
    elif sp.QRm is not None:
        t.modal(sp.QRm, npd)
        _child_sums(t, sp, F)
    else:
        t.modal(sp.sqrtQ, npd)
        t.modal(sp.sqrtR, npd)
        _child_sums(t, sp, n)
        _child_sums(t, sp, m)
    t.ew += nl * F                             # constraint rows + SOC sums
    t.table(sp.l_active)
    t.ew += lf * sp.l_rows
    if sp.l_G is not None:
        t.table(sp.l_G)
        t.mm += 2 * lf * sp.l_rows * n
    t.modal(sp.sqrtP, lf)
    t.ew += lf * n
    t.table(sp.nz_mask)
    t.ew += 3 * npd + 2 * lf                   # tau and s halves
    return t


def _riccati_backward(t, sp, k, rows):
    n, m = sp.n, sp.m
    if sp.rinv_s[k] is not None:
        t.table(sp.rinv_s[k], sp.k_s[k], sp.sumapb_s[k])
        t.mm += 2 * rows * (m * m + 2 * m * n)
    elif sp.rinv_ms and sp.rinv_ms[k] is not None:
        t.table(sp.rinv_ms[k], sp.k_ms[k], sp.sumapb_ms[k], sp.riccati_cls)
        t.mm += 2 * rows * (m * m + 2 * m * n) * sp.rinv_ms[k].shape[0]
    else:
        t.table(sp.Rinv, sp.K, sp.sumAPB)
        t.mm += 2 * rows * (m * m + 2 * m * n)
    t.ew += rows * (3 * m + 4 * n)


def _riccati_input(t, sp, k, rows):
    n, m = sp.n, sp.m
    if sp.k_s[k] is not None:
        t.table(sp.k_s[k])
        t.mm += 2 * rows * n * m
    elif sp.k_ms and sp.k_ms[k] is not None:
        t.table(sp.k_ms[k], sp.riccati_cls)
        t.mm += 2 * rows * n * m * sp.k_ms[k].shape[0]
    else:
        t.table(sp.K)
        t.mm += 2 * rows * n * m
    t.ew += rows * m


def _project_dynamics_stages(sp):
    t = _Tally()
    n, m = sp.n, sp.m
    F = n + m
    ns = sp.num_stages
    t.ew += (sp.num_nodes - sp.stage_start[ns - 1]) * n    # q_leaf = -x
    for k in range(ns - 2, -1, -1):
        a, b, a2, b2 = _stage(sp, k)
        c = sp.stage_child[k]
        if sp.ab_bwd[k] is not None:
            t.table(sp.ab_bwd[k])
            t.mm += 2 * (b - a) * c * n * F
        else:
            t.modal(sp.ABm, b2 - a2)
            if c is not None:
                t.ew += (b2 - a2) * F
            else:
                t.table(sp.child_idx, sp.child_mask)
                t.ew += 2 * (b - a) * sp.d_max * F
        _riccati_backward(t, sp, k, b - a)
    for k in range(ns - 1):
        a, b, a2, b2 = _stage(sp, k)
        _riccati_input(t, sp, k, b - a)
        if sp.ab_fwd[k] is not None:
            t.table(sp.ab_fwd[k])
            t.mm += 2 * (b - a) * F * sp.ab_fwd[k].shape[1] * n
        else:
            if sp.stage_child[k] is None:
                t.table(sp.anc)
            t.modal(sp.ABm, b2 - a2)
    return t


def _project_kernel(sp):
    t = _Tally()
    D = sp.D
    ss = sp.stage_start
    t.table(sp.Pi)
    t.mm += 2 * sp.nl_pad * D * D
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        if sp.stage_child[k0] is None:     # the ragged stages' slots
            t.table(sp.child_idx, sp.child_mask, sp.anc, sp.child_rank,
                    sp.node_mask)
            t.ew += 2 * (ss[k1] - ss[k0]) * sp.d_max
            if sp.node_mask is not None:
                t.ew += 2 * (ss[k1 + 1] - ss[k0 + 1])
    return t


def _prox_f(sp):
    t = _project_dynamics_stages(sp).add(_project_kernel(sp))
    t.ew += 1                                  # s_0 - alpha
    return t


def _soc(rows, head):
    """Elementwise work of the three-case SOC projection of rows of a
    ``head``-wide head and a scalar tail."""
    return 3 * rows * head + 4 * rows


def _g_conj(sp):
    t = _Tally()
    nl, npd, lf, Y = sp.nl_pad, sp.np_pad, sp.lf_pad, sp.Y
    t.table(sp.risk_free_rows, sp.risk_zero_rows)
    t.ew += nl * Y                             # max(0, .) rows
    if sp.risk_soc_rows is not None:
        t.table(sp.risk_soc_rows, sp.risk_soc_tail)
        t.ew += 6 * nl * Y + 4 * nl
    t.ew += nl                                 # e2
    t.ew += _soc(npd, sp.n + sp.m + 1) + _soc(lf, sp.n + 1)
    for rows, cols, parts in ((nl, sp.nl_rows, (sp.nl_lo, sp.nl_hi,
                                                sp.nl_ball_c, sp.nl_ball_r)),
                              (lf, sp.l_rows, (sp.l_lo, sp.l_hi,
                                               sp.l_ball_c, sp.l_ball_r))):
        t.table(*parts)
        t.ew += 7 * rows * cols + 2 * rows    # ball and box, then a select
    return t


def _work(sp, t, reads, writes, unfused=None):
    """The dict of a component: ``reads`` and ``writes`` are elements of
    the iterates besides the tables of ``t``."""
    esize = _esize(sp.dtype)
    out = dict(flop=t.mm + t.ew, flop_mm=t.mm, flop_ew=t.ew,
               bytes=(reads + writes) * esize + t.bytes())
    if unfused is not None:
        out["bytes_unfused"] = unfused
    return out


def _elements(sp):
    """(primal, dual, L z's distinct dual) elements."""
    ps, ds = primal_shapes(sp), dual_shapes(sp)
    return _leaves(ps), _leaves(ds), _leaves(ds, _LZ_REPEATS)


def ell(sp) -> dict:
    """L: reads z, writes the dual but e1 (z's y), e6 (e5) and e13
    (e12)."""
    P, _, DL = _elements(sp)
    return _work(sp, _ell(sp), P, DL)


def ell_t(sp) -> dict:
    """L': reads a dual of 11 leaves, writes the primal."""
    P, D, _ = _elements(sp)
    return _work(sp, _ell_t(sp), D, P)


def project_dynamics_stages(sp) -> dict:
    """The torch stage path: reads x, u and x0, writes x and u."""
    io = sp.np_pad * sp.n + sp.nl_pad * sp.m
    return _work(sp, _project_dynamics_stages(sp), io + sp.n, io)


def project_dynamics(sp) -> dict:
    """The dynamics projection as ``prox.project_dynamics`` dispatches it:
    K1's count (:func:`sweep_work`, all products) where the problem takes
    K1, the stage path's otherwise."""
    if not sweep_eligible(sp):
        return project_dynamics_stages(sp)
    w = sweep_work(sp)
    return dict(flop=w["flop"], flop_mm=w["flop"], flop_ew=0,
                bytes=w["bytes"])


def project_kernel(sp) -> dict:
    """The kernel projection: reads and writes y, tau and s."""
    io = sp.nl_pad * sp.Y + 2 * sp.np_pad
    return _work(sp, _project_kernel(sp), io, io)


def prox_f(sp) -> dict:
    """prox_f: reads the primal, alpha and x0, writes the primal."""
    P, _, _ = _elements(sp)
    esize = _esize(sp.dtype)
    s_shift = (2 * sp.np_pad + 1) * esize
    return _work(sp, _prox_f(sp), P + 1 + sp.n, P, unfused=(
        s_shift + project_dynamics(sp)["bytes"]
        + project_kernel(sp)["bytes"]))


def g_conj_projections(sp) -> dict:
    """The dual prox's projections: reads and writes a dual."""
    _, D, _ = _elements(sp)
    return _work(sp, _g_conj(sp), D, D)


def dual_update(sp, lanes: int = 1) -> dict:
    """The dual-update kernel (``ops/dual.py``) on ``lanes`` lanes: reads
    eta, L z and L z+ (L z's e6 is its e5, its e13 its e12: each once), the
    half-shift's four nonzero parts, alpha2 and what each row's
    projection needs of the tables (every row's risk masks and radius, a
    box row's bounds, a ball row's centre; shared by the lanes); writes
    eta+. Its operations: the projections' (:func:`g_conj_projections`)
    and eight an element for the Moreau combine and the step."""
    _, D, _ = _elements(sp)
    Dz = _leaves(dual_shapes(sp), ("e6", "e13"))
    esize = _esize(sp.dtype)
    t = _g_conj(sp)
    tables = sum(v.numel() * v.element_size() for v in (
        sp.risk_free_rows, sp.risk_zero_rows, sp.risk_soc_rows,
        sp.risk_soc_tail, sp.nl_ball_r, sp.l_ball_r) if v is not None)
    for r, cols in ((sp.nl_ball_r, sp.nl_rows), (sp.l_ball_r, sp.l_rows)):
        balls = int(torch.isfinite(r).sum())
        tables += (2 * (r.numel() - balls) + balls) * cols * esize
    reads = lanes * (D + 2 * Dz) + 2 * sp.np_pad + 2 * sp.lf_pad + lanes
    ew = lanes * (t.ew + 8 * D)
    return dict(flop=ew, flop_mm=0, flop_ew=ew,
                bytes=(reads + lanes * D) * esize + tables)


def over_relax(sp, lanes: int = 1) -> dict:
    """The over-relaxation kernel (``ops/relax.py``) on ``lanes`` lanes:
    reads the current (z, eta, L z, L'eta) and the step's (L z+'s e1 is
    z+'s y, its e6 its e5, its e13 its e12: each once), writes the relaxed
    four; three operations an element (a subtraction, a product, a
    sum)."""
    P, D, DL = _elements(sp)
    S = 2 * P + 2 * D
    ew = lanes * 3 * S
    return dict(flop=ew, flop_mm=0, flop_ew=ew,
                bytes=lanes * (S + (2 * P + D + DL) + S) * _esize(sp.dtype))


def max_norm(sp) -> dict:
    """The max-norm of a primal: reads it, writes one number."""
    P, _, _ = _elements(sp)
    t = _Tally()
    t.ew += 2 * P                              # abs, max
    return _work(sp, t, P, 1)


def _step(sp):
    """(tally, unfused bytes) of one CP step."""
    P, D, DL = _elements(sp)
    esize = _esize(sp.dtype)
    t = _prox_f(sp).add(_ell(sp)).add(_g_conj(sp)).add(_ell_t(sp))
    t.ew += 2 * P + 6 * D + 2 * D              # the two steps, Moreau
    unfused = (esize * ((2 * P + 1 + P)        # z - a1 L'eta
                        + (D + DL + D + D + 1 + D)   # the dual's argument
                        + (2 * D + 1 + D))     # a2 (mod - proj)
               + prox_f(sp)["bytes"] + ell(sp)["bytes"]
               + g_conj_projections(sp)["bytes"] + ell_t(sp)["bytes"])
    return t, unfused


def _residuals(sp):
    """(tally, unfused bytes) of the residuals of one step."""
    P, D, DL = _elements(sp)
    esize = _esize(sp.dtype)
    t = _ell_t(sp)
    t.ew += 16 * P + 9 * D                     # xi, delta and their norms
    unfused = (esize * ((4 * P + 2 * D + DL + D + 2)   # the differences
                        + (3 * P + 2 * D)             # xi_1, xi_2, d's
                        + (4 * P + 2 * D + 6))        # the max-norms
               + ell_t(sp)["bytes"])
    return t, unfused


def _step_io(sp):
    """Elements a step reads and writes: z, eta, L z, L'eta (and alpha1,
    alpha2, x0 and the half-shift dual read)."""
    P, D, DL = _elements(sp)
    return 2 * P + D + DL + 2 + sp.n + D, 2 * P + D + DL


def cp_step(sp) -> dict:
    """One CP step (two operator applies and the prox maps)."""
    t, unfused = _step(sp)
    reads, writes = _step_io(sp)
    return _work(sp, t, reads, writes, unfused)


def cp_iteration(sp) -> dict:
    """A step and its residuals (three applies); writes err and derr
    besides the step's outputs."""
    t, unfused = _step(sp)
    r, r_unfused = _residuals(sp)
    reads, writes = _step_io(sp)
    return _work(sp, t.add(r), reads, writes + 6, unfused + r_unfused)


def production_trip(sp, unroll: int) -> dict:
    """One trip of the production loop (``unroll`` steps, the residuals of
    the last), per iteration: the trip's reads and writes once, over
    ``unroll``."""
    step, unfused = _step(sp)
    res, r_unfused = _residuals(sp)
    reads, writes = _step_io(sp)
    esize = _esize(sp.dtype)
    mm = unroll * step.mm + res.mm
    ew = unroll * step.ew + res.ew
    tables = step.add(res).bytes()
    return dict(flop=(mm + ew) / unroll, flop_mm=mm / unroll,
                flop_ew=ew / unroll,
                bytes=((reads + writes + 6) * esize + tables) / unroll,
                bytes_unfused=(unroll * unfused + r_unfused) / unroll)
