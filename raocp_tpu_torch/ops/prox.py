"""Proximal maps of the Chambolle-Pock iteration on tensors (counterpart of
:mod:`raocp_tpu.ops.prox`).

prox_f — reference ``cache.py:248-317`` — is the projection of (x, u) onto
the dynamics subspace via a backward/forward dynamic-programming sweep, plus
the projection of (y, tau+, s+) onto the risk-recursion kernel (one
precomputed-projector batched matmul). On trees whose every nonleaf stage is
stage-constant the sweep goes to the hand-written sweep kernel
(:mod:`raocp_tpu_torch.ops.sweep`); other trees take the torch branches
below, as they take the XLA path in the JAX package. So does a rank's block
of the subtree partition: its frontier stage has no stage-stacked block,
and the sweep completes the frontier parents' sums with an all-reduce, as
the JAX package's partition takes no Pallas kernel (ROADMAP.md item 16c).
A rank's block of the flat partition holds parts of stages, so it takes
the torch stage path too (:func:`_flat_prox_f`): the sweep and the kernel
projection run fused there, completed with the planned halo exchanges of
:mod:`raocp_tpu_torch.parallel.flat`.

prox_g* — reference ``cache.py:321-393`` — is computed via the Moreau
identity: scale, epigraph half-shifts, batched cone/box projections, and the
final ``alpha * (modified - projected)`` combine.

Every map takes the iterates with or without a leading lane axis (a batch
of solves from B initial states): the problem's tables have none and
broadcast, and with no lane axis each map runs the arithmetic of one
solve.
"""

import torch

from raocp_tpu_torch.core.stacked import StackedProblem
from raocp_tpu_torch.core.variables import Dual, Primal, lane_view
from raocp_tpu_torch.ops.cones import (constraint_project, nonneg_project,
                                       risk_dual_project, soc_project_parts)
from raocp_tpu_torch.ops.operator import (_child_rel, _flat_own_children,
                                          _flat_own_parents,
                                          _flat_parent_rows,
                                          _flat_parent_span, _flat_reduce,
                                          _flat_stacked_rows, _frontier_psum,
                                          _same_child, repad, stage_groups)
from raocp_tpu_torch.ops.sweep import project_dynamics_sweep, sweep_eligible

__all__ = ["prox_f", "prox_g_conj", "project_dynamics", "project_kernel",
           "g_conj_projections", "half_shift_dual"]


def _select_rows(allm, cls):
    """rows[..., i, :] = allm[..., i, cls[i], :] for allm [..., W, M, a]."""
    index = cls[:, None, None].expand(
        tuple(allm.shape[:-3]) + (-1, 1, allm.shape[-1]))
    return torch.gather(allm, -2, index)[..., 0, :]


def _modal_rows(v, tables, cls):
    """rows[i] = tables[cls[i]] @ v[i] without per-node stacks: all-modes
    matmul then per-row select (tables [M, a, b], v [..., W, b] ->
    [..., W, a])."""
    return _select_rows(torch.einsum("...ib,wab->...iwa", v, tables), cls)


def _modal_rows_t(v, tables, cls):
    """rows[i] = tables[cls[i]]' @ v[i] (tables [M, a, b], v [..., W, a])."""
    return _select_rows(torch.einsum("...ia,wab->...iwb", v, tables), cls)


def _riccati_backward(sp: StackedProblem, k: int, x_k, u_k, abtq, rows,
                      cls):
    """(d_k, q_k) of stage k's nonleaf rows from their children's summed
    [A | B]'q (``abtq``): ``rows`` slices the dense per-node stacks,
    ``cls`` holds the rows' mode classes (or None)."""
    n = sp.n
    sum_atq, sum_btq = abtq[..., :n], abtq[..., n:]
    if sp.rinv_s[k] is not None:
        # stage-constant Riccati: matmuls against one tiny matrix
        d_k = (u_k - sum_btq) @ sp.rinv_s[k].T
        q_k = (-x_k + (d_k - u_k + sum_btq) @ sp.k_s[k]
               + d_k @ sp.sumapb_s[k].T + sum_atq)
    elif sp.rinv_ms and sp.rinv_ms[k] is not None:
        # mode-constant Riccati (post-stopping chain stage)
        d_k = _modal_rows(u_k - sum_btq, sp.rinv_ms[k], cls)
        q_k = (-x_k + _modal_rows_t(d_k - u_k + sum_btq, sp.k_ms[k], cls)
               + _modal_rows(d_k, sp.sumapb_ms[k], cls) + sum_atq)
    else:
        d_k = torch.einsum("iab,...ib->...ia", sp.Rinv[rows], u_k - sum_btq)
        q_k = (-x_k
               + torch.einsum("iab,...ia->...ib", sp.K[rows],
                              d_k - u_k + sum_btq)
               + torch.einsum("iab,...ib->...ia", sp.sumAPB[rows], d_k)
               + sum_atq)
    return d_k, q_k


def _riccati_input(sp: StackedProblem, k: int, x_k, d_k, rows, cls):
    """u_k = K x_k + d_k on stage k's nonleaf rows (``rows`` and ``cls``
    as in :func:`_riccati_backward`)."""
    if sp.k_s[k] is not None:
        return x_k @ sp.k_s[k].T + d_k
    if sp.k_ms and sp.k_ms[k] is not None:
        return _modal_rows(x_k, sp.k_ms[k], cls) + d_k
    return torch.einsum("iab,...ib->...ia", sp.K[rows], x_k) + d_k


def project_dynamics(sp: StackedProblem, x_in, u_in, x0):
    """Project (x, u) onto {x_j = A_j x_i + B_j u_i, x_0 = x0}: x_in
    [..., np_pad, n], u_in [..., nl_pad, m], x0 [..., n] (a leading lane
    axis for a batch of solves).

    Backward sweep (parity: reference ``cache.py:259-280``):
      q_leaf = -x_leaf
      d_i = Rtilde_i^{-1} (u_i - sum_j B_j'q_j)
      q_i = -x_i + K_i'(d_i - u_i) + sum_j Abar_j'(P_jB_j d_i + q_j)
    Forward rollout (``cache.py:282-288``):
      u_i = K_i x_i + d_i ;  x_j = Abar_j x_i + B_j d_i
    """
    if sp.flat is not None:
        raise ValueError("on a rank's block of the flat partition the "
                         "dynamics and kernel projections run fused, in "
                         "prox_f")
    if sweep_eligible(sp):
        return project_dynamics_sweep(sp, x_in, u_in, x0)

    ss = sp.stage_start
    N, NL, n, m = sp.num_nodes, sp.num_nonleaf, sp.n, sp.m
    ns = sp.num_stages
    lead = tuple(x_in.shape[:-2])

    # per-stage slices, assembled once at the end; the closed-loop
    # matrices Abar_j never appear as a dense stack: Abar_j'q = A_j'q +
    # K_i'(B_j'q) and Abar_j x + B_j d = A_j x + B_j u
    q_stage = [None] * ns
    q_stage[ns - 1] = -x_in[..., ss[ns - 1]:N, :]
    d_stage = [None] * (ns - 1)
    for k in range(ns - 2, -1, -1):
        a, b = ss[k], ss[k + 1]        # nonleaf nodes of stage k
        a2, b2 = ss[k + 1], ss[k + 2]  # their children
        qc = q_stage[k + 1]
        c = sp.stage_child[k]
        u_k = u_in[..., a:b, :]
        if sp.ab_bwd[k] is not None:
            # stage-stacked mode block: modal rmatvec + mode select + child
            # reduction in one contraction
            abtq = torch.tensordot(qc.reshape(lead + (b - a, c, n)),
                                   sp.ab_bwd[k],
                                   dims=([-2, -1], [0, 1]))    # [W, n+m]
        else:
            # fused [A | B]'q: one mode-grouped rmatvec + one reduction
            w = sp.ABm.slice_rows(a2, b2).rmatvec(qc)
            if c is not None:          # uniform branching: gather-free
                abtq = w.reshape(lead + (b - a, c, n + m)).sum(dim=-2)
            else:
                rel = _child_rel(sp, a, b, a2, b2)
                mask = sp.child_mask[a:b][..., None]
                abtq = torch.sum(w[..., rel, :] * mask, dim=-2)
            abtq = _frontier_psum(sp, k, abtq)
        d_stage[k], q_stage[k] = _riccati_backward(
            sp, k, x_in[..., a:b, :], u_k, abtq, slice(a, b),
            None if sp.riccati_cls is None else sp.riccati_cls[a:b])

    x_stage = [None] * ns
    u_stage = [None] * (ns - 1)
    x_stage[0] = x0.reshape(lead + (1, n))
    for k in range(ns - 1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        u_k = _riccati_input(
            sp, k, x_stage[k], d_stage[k], slice(a, b),
            None if sp.riccati_cls is None else sp.riccati_cls[a:b])
        u_stage[k] = u_k
        xu_k = torch.cat([x_stage[k], u_k], dim=-1)           # [W, n+m]
        c = sp.stage_child[k]
        if sp.ab_fwd[k] is not None:
            x3 = torch.tensordot(xu_k, sp.ab_fwd[k], dims=([-1], [0]))
            x_stage[k + 1] = x3.reshape(lead + (b2 - a2, n))
        else:
            if c is not None:          # uniform: parents repeat, no gather
                xu_par = torch.repeat_interleave(xu_k, c, dim=-2)
            else:
                xu_par = xu_k[..., sp.anc[a2:b2] - a, :]
            # x_j = A_j x_i + B_j u_i — one fused [A | B] matvec
            x_stage[k + 1] = sp.ABm.slice_rows(a2, b2).matvec(xu_par)

    pad_x = sp.np_pad - N
    pad_u = sp.nl_pad - NL
    x = torch.cat(x_stage + ([x_in.new_zeros(lead + (pad_x, n))]
                             if pad_x else []), dim=-2)
    u = torch.cat(u_stage + ([u_in.new_zeros(lead + (pad_u, m))]
                             if pad_u else []), dim=-2)
    return x, u


def _gather_child_slots(sp: StackedProblem, v):
    """[..., np_pad] node values -> [..., nl_pad, d_max] per-parent
    child-slot table (zero-padded slots). Uniform stage groups reshape;
    ragged stages gather."""
    ss = sp.stage_start
    d = sp.d_max
    lead = tuple(v.shape[:-1])
    parts = []
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        c = sp.stage_child[k0]
        if c is not None:
            blk = v[..., a2:b2].reshape(lead + (b - a, c))
            if c < d:
                blk = torch.cat([blk, v.new_zeros(lead + (b - a, d - c))],
                                dim=-1)
            parts.append(blk)
        else:                      # single ragged stage
            parts.append(_frontier_psum(
                sp, k0, v[..., sp.child_idx[a:b]] * sp.child_mask[a:b]))
    tail = sp.nl_pad - sp.num_nonleaf
    if tail:
        parts.append(v.new_zeros(lead + (tail, d)))
    return torch.cat(parts, dim=-2)


def _scatter_parent_slots(sp: StackedProblem, w, orig):
    """[..., nl_pad, d_max] per-parent slot table -> [..., np_pad] node
    values: node j reads slot child_rank[j] of its parent; root/padding
    keep ``orig``."""
    ss = sp.stage_start
    lead = tuple(w.shape[:-2])
    parts = [orig[..., :1]]
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        c = sp.stage_child[k0]
        if c is not None:
            parts.append(w[..., a:b, :c].reshape(lead + (-1,)))
        else:                      # single ragged stage
            got = w[..., sp.anc[a2:b2], sp.child_rank[a2:b2]]
            if sp.node_mask is not None:
                # interior ghost rows carry clipped anc/rank indices that
                # alias real parent slots: mask them back to zero
                got = got * sp.node_mask[a2:b2]
            parts.append(got)
    tail = sp.np_pad - ss[sp.num_stages]
    if tail:
        parts.append(orig[..., ss[sp.num_stages]:])
    return torch.cat(parts, dim=-1)


def project_kernel(sp: StackedProblem, y, tau, s):
    """Project (y_i, tau_children, s_children) onto ker(M_i) for every
    nonleaf node i at once (parity: reference ``cache.py:290-317``, with the
    per-iteration lstsq replaced by the precomputed orthogonal projector).
    The iterates may carry leading lane dims."""
    if sp.flat is not None:
        raise ValueError("on a rank's block of the flat partition the "
                         "dynamics and kernel projections run fused, in "
                         "prox_f")
    Y = sp.Y
    d = sp.d_max
    tau_c = _gather_child_slots(sp, tau)           # [..., NL, d]
    s_c = _gather_child_slots(sp, s)
    v = torch.cat([y, tau_c, s_c], dim=-1)         # [..., NL, D]
    w = torch.einsum("iab,...ib->...ia", sp.Pi, v)

    y_new = w[..., :Y]
    tau_new = _scatter_parent_slots(sp, w[..., Y:Y + d], tau)
    s_new = _scatter_parent_slots(sp, w[..., Y + d:], s)
    return y_new, tau_new, s_new


def prox_f(sp: StackedProblem, z: Primal, alpha, x0) -> Primal:
    """prox of alpha*f at z (parity: reference ``cache.py:248-251``):
    s_0 shift, dynamics projection, kernel projection. In a batch of
    solves z carries a lane axis, x0 is [B, n] and ``alpha`` a number or
    per lane [B]. On a rank's block of the flat partition,
    :func:`_flat_prox_f`."""
    if sp.flat is not None:
        return _flat_prox_f(sp, z, alpha, x0)
    s = torch.cat([z.s[..., :1] - lane_view(alpha, z.s), z.s[..., 1:]],
                  dim=-1)
    x, u = project_dynamics(sp, z.x, z.u, x0)
    y, tau, s = project_kernel(sp, z.y, z.tau, s)
    return Primal(x=x, u=u, y=y, tau=tau, s=s)


def _flat_slots(sp: StackedProblem, v, w_lo: int):
    """[..., nl block, d_max] child-slot table of this rank's nonleaf rows
    from ``v`` [..., window] (their children's values, from global row
    ``w_lo``); zero slots and ghost rows."""
    d = sp.d_max
    q0 = sp.flat.start["nl"]
    lead = tuple(v.shape[:-1])
    parts = []
    for k0, _, pa, pb, ca, cb in _flat_own_parents(sp, _same_child(sp)):
        c = sp.stage_child[k0]
        if c is not None:
            blk = v[..., ca - w_lo:cb - w_lo].reshape(lead + (pb - pa, c))
            if c < d:
                blk = torch.cat([blk, v.new_zeros(lead + (pb - pa, d - c))],
                                dim=-1)
        else:
            rel = torch.clamp(sp.child_idx[pa - q0:pb - q0] - w_lo, 0,
                              v.shape[-1] - 1)
            blk = v[..., rel] * sp.child_mask[pa - q0:pb - q0]
        parts.append(blk)
    out = torch.cat(parts, dim=-2) if parts \
        else v.new_zeros(lead + (0, d))
    return repad(out, sp.nl_pad, -2)


def _flat_scatter(sp: StackedProblem, w, w_lo: int, orig):
    """[..., np block] node values: each real non-root row of this rank's
    all-node block reads slot ``child_rank`` of its parent's row of ``w``
    (a window of parent rows from global row ``w_lo``); the root and the
    ghost rows keep ``orig``."""
    fp = sp.flat
    lo, hi = fp.child_rows
    p0 = fp.start["np"]
    parts = [orig[..., :lo - p0]]
    for k0, ca, cb in _flat_own_children(sp, _same_child(sp), lo, hi):
        c = sp.stage_child[k0]
        if c is not None:
            q0, q1, off = _flat_parent_span(sp, k0, ca, cb)
            rows = w[..., q0 - w_lo:q1 - w_lo, :c]
            rows = rows.reshape(tuple(rows.shape[:-2]) + (-1,))
            parts.append(rows[..., off:off + cb - ca])
        else:
            parts.append(w[..., sp.anc[ca - p0:cb - p0] - w_lo,
                           sp.child_rank[ca - p0:cb - p0]])
    parts.append(orig[..., hi - p0:])
    return torch.cat(parts, dim=-1)


def _flat_children_x(sp: StackedProblem, k: int, win, w_lo: int, ca: int,
                     cb: int, table, base: int, anc):
    """x of the stage-(k+1) rows [ca, cb) from their parents' [x; u] rows
    in ``win`` (from global row ``w_lo``): through the stage-stacked block,
    or the fused [A | B] of ``table`` (rows from global row ``base``)."""
    if sp.ab_fwd[k] is not None:
        return _flat_stacked_rows(sp, k, win, w_lo, ca, cb, sp.ab_fwd[k])
    xu_par = _flat_parent_rows(sp, k, win, w_lo, ca, cb, anc)
    return table.slice_rows(ca - base, cb - base).matvec(xu_par)


def _flat_prox_f(sp: StackedProblem, z: Primal, alpha, x0) -> Primal:
    """prox_f on a rank's blocks of the flat partition (the module
    docstring of :mod:`raocp_tpu_torch.parallel.flat`): the dynamics sweep
    computes each nonleaf stage's rows on the rank that holds their u and
    the leaf stage's on the rank that holds their x; the kernel projection
    computes on the nonleaf block. Exchanges: one that also brings the
    kernel projection's child slots, one a stage in each direction of the
    sweep, and one that also brings the parents' slots and sends the
    nonleaf x back to the all-node block: 2 (num_stages - 1) in all."""
    fp = sp.flat
    n, m, Y = sp.n, sp.m, sp.Y
    ns = sp.num_stages
    lead = tuple(z.x.shape[:-2])
    q0, p0 = fp.start["nl"], fp.start["np"]
    nlo = fp.real["nl"][0]
    tables = fp.tables
    s = z.s
    if fp.rank == 0:                 # the root is rank 0's row 0
        s = torch.cat([s[..., :1] - lane_view(alpha, s), s[..., 1:]],
                      dim=-1)
    x_nl, x_last, ts = fp.exchange(sp, [
        ("np>nl", z.x), ("np>child_last", z.x),
        ("np>child", torch.stack([z.tau, s], dim=-1))])

    # the kernel projection's child slots and projector (rank-local)
    c_lo = fp.window("np>child")[0]
    v = torch.cat([z.y, _flat_slots(sp, ts[..., 0], c_lo),
                   _flat_slots(sp, ts[..., 1], c_lo)], dim=-1)
    w = torch.einsum("iab,...ib->...ia", sp.Pi, v)

    def empty(cols):
        return z.x.new_zeros(lead + (0, cols))

    def cls(pa, pb):
        c = tables["riccati_cls_nl"]
        return None if c is None else c[pa - q0:pb - q0]

    # backward sweep: q of each stage's nonleaf rows, on the nonleaf block
    q_stage = [None] * (ns - 1)
    d_stage = [None] * (ns - 1)
    for k in range(ns - 2, -1, -1):
        if k == ns - 2:
            qc, w_lo = -x_last, fp.window("np>child_last")[0]
        else:
            (qc,) = fp.exchange(sp, [(f"q{k}", q_stage[k + 1])])
            w_lo = fp.window(f"q{k}")[0]
        pa, pb = fp.stage_rows[k]
        if pa == pb:
            q_stage[k], d_stage[k] = empty(n), empty(m)
            continue
        ca, cb = fp.children(pa, pb)
        qc = qc[..., ca - w_lo:cb - w_lo, :]
        if sp.ab_bwd[k] is not None:
            abtq = torch.tensordot(
                qc.reshape(lead + (pb - pa, sp.stage_child[k], n)),
                sp.ab_bwd[k], dims=([-2, -1], [0, 1]))
        else:
            c_lo = fp.window("np>child")[0]
            wq = tables["ABm_c"].slice_rows(ca - c_lo, cb - c_lo).rmatvec(qc)
            abtq = _flat_reduce(sp, k, wq, pa, pb, ca)
        d_stage[k], q_stage[k] = _riccati_backward(
            sp, k, x_nl[..., pa - nlo:pb - nlo, :],
            z.u[..., pa - q0:pb - q0, :], abtq, slice(pa - q0, pb - q0),
            cls(pa, pb))

    # forward rollout: x and u of each stage's nonleaf rows, on the
    # nonleaf block
    pa, pb = fp.stage_rows[0]
    x_stage = [x0.reshape(lead + (1, n)) if pb > pa else empty(n)]
    u_stage = []
    for k in range(ns - 1):
        pa, pb = fp.stage_rows[k]
        u_stage.append(_riccati_input(
            sp, k, x_stage[k], d_stage[k], slice(pa - q0, pb - q0),
            cls(pa, pb)) if pb > pa else empty(m))
        xu_k = torch.cat([x_stage[k], u_stage[k]], dim=-1)
        if k == ns - 2:
            break
        (win,) = fp.exchange(sp, [(f"xu{k}", xu_k)])
        ca, cb = fp.stage_rows[k + 1]
        x_stage.append(_flat_children_x(
            sp, k, win, fp.window(f"xu{k}")[0], ca, cb, tables["ABm_nl"],
            nlo, tables["anc_nl"][ca - q0:cb - q0]) if cb > ca
            else empty(n))

    # the leaf stage's parents, the nonleaf x back to the all-node block,
    # the kernel projection's parent slots
    par, x_np, slots = fp.exchange(sp, [
        ("xu_last", xu_k), ("nl>np", torch.cat(x_stage, dim=-2)),
        ("nl>par", w[..., Y:])])
    ca, cb = fp.leaf_rows
    x_leaf = _flat_children_x(
        sp, ns - 2, par, fp.window("xu_last")[0], ca, cb, sp.ABm, p0,
        sp.anc[ca - p0:cb - p0]) if cb > ca else empty(n)
    x = repad(torch.cat([x_np, x_leaf], dim=-2), sp.np_pad, -2)
    u = repad(torch.cat(u_stage, dim=-2), sp.nl_pad, -2)
    s_lo = fp.window("nl>par")[0]
    d = sp.d_max
    tau = _flat_scatter(sp, slots[..., :d], s_lo, z.tau)
    s = _flat_scatter(sp, slots[..., d:], s_lo, s)
    return Primal(x=x, u=u, y=w[..., :Y], tau=tau, s=s)


def g_conj_projections(sp: StackedProblem, mod: Dual) -> Dual:
    """The batched cone/box/ball projections of the dual prox (reference
    algo 7, ``cache.py:349-390``), applied to the already scaled-and-shifted
    ``mod`` vector (leading lane dims allowed)."""
    n, m = sp.n, sp.m
    p1 = risk_dual_project(mod.e1, sp.risk_free_rows, sp.risk_zero_rows,
                           sp.risk_soc_rows, sp.risk_soc_tail)
    p2 = nonneg_project(mod.e2)
    soc_head = torch.cat([mod.e3, mod.e4, mod.e5[..., None]], dim=-1)
    px, pt = soc_project_parts(soc_head, mod.e6)
    p3, p4, p5, p6 = px[..., :n], px[..., n:n + m], px[..., -1], pt
    p7 = constraint_project(mod.e7, sp.nl_lo, sp.nl_hi,
                            sp.nl_ball_c, sp.nl_ball_r)
    leaf_head = torch.cat([mod.e11, mod.e12[..., None]], dim=-1)
    plx, plt = soc_project_parts(leaf_head, mod.e13)
    p11, p12, p13 = plx[..., :n], plx[..., -1], plt
    p14 = constraint_project(mod.e14, sp.l_lo, sp.l_hi,
                             sp.l_ball_c, sp.l_ball_r)
    return Dual(e1=p1, e2=p2, e3=p3, e4=p4, e5=p5, e6=p6, e7=p7,
                e11=p11, e12=p12, e13=p13, e14=p14)


def half_shift_dual(sp: StackedProblem) -> Dual:
    """The constant epigraph half-shift vector (reference add_halves,
    ``cache.py:334-347``): -1/2 on e5/e12, +1/2 on e6/e13, zero elsewhere
    (masked so root/padded rows stay zero)."""
    zero = sp.zero_dual()
    half_np = 0.5 * sp.nz_mask
    if sp.lf_half_mask is not None:
        half_lf = 0.5 * sp.lf_half_mask
    else:
        real = torch.arange(sp.lf_pad, device=sp.device) < sp.num_leaf
        half_lf = 0.5 * real.to(sp.dtype)
    return zero._replace(e5=-half_np, e6=half_np,
                         e12=-half_lf, e13=half_lf)


def prox_g_conj(sp: StackedProblem, eta: Dual, alpha) -> Dual:
    """prox of alpha*g* at eta via the Moreau identity
    (parity: reference ``cache.py:321-393``)."""
    inv = 1.0 / alpha
    mod = Dual(*(inv * part for part in eta))
    mod = mod._replace(e5=mod.e5 - 0.5, e6=mod.e6 + 0.5,
                       e12=mod.e12 - 0.5, e13=mod.e13 + 0.5)
    proj = g_conj_projections(sp, mod)
    # Moreau: eta+ = alpha * (modified - projected)
    return Dual(*(alpha * (mp - pp) for mp, pp in zip(mod, proj)))
