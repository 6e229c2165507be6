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
from raocp_tpu_torch.ops.operator import (_child_rel, _frontier_psum,
                                          _same_child, stage_groups)
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
        sum_atq, sum_btq = abtq[..., :n], abtq[..., n:]
        if sp.rinv_s[k] is not None:
            # stage-constant Riccati: matmuls against one tiny matrix
            d_k = (u_k - sum_btq) @ sp.rinv_s[k].T
            q_stage[k] = (-x_in[..., a:b, :]
                          + (d_k - u_k + sum_btq) @ sp.k_s[k]
                          + d_k @ sp.sumapb_s[k].T
                          + sum_atq)
        elif sp.rinv_ms and sp.rinv_ms[k] is not None:
            # mode-constant Riccati (post-stopping chain stage)
            cls = sp.riccati_cls[a:b]
            d_k = _modal_rows(u_k - sum_btq, sp.rinv_ms[k], cls)
            q_stage[k] = (-x_in[..., a:b, :]
                          + _modal_rows_t(d_k - u_k + sum_btq,
                                          sp.k_ms[k], cls)
                          + _modal_rows(d_k, sp.sumapb_ms[k], cls)
                          + sum_atq)
        else:
            d_k = torch.einsum("iab,...ib->...ia", sp.Rinv[a:b],
                               u_k - sum_btq)
            q_stage[k] = (-x_in[..., a:b, :]
                          + torch.einsum("iab,...ia->...ib", sp.K[a:b],
                                         d_k - u_k + sum_btq)
                          + torch.einsum("iab,...ib->...ia", sp.sumAPB[a:b],
                                         d_k)
                          + sum_atq)
        d_stage[k] = d_k

    x_stage = [None] * ns
    u_stage = [None] * (ns - 1)
    x_stage[0] = x0.reshape(lead + (1, n))
    for k in range(ns - 1):
        a, b = ss[k], ss[k + 1]
        a2, b2 = ss[k + 1], ss[k + 2]
        if sp.k_s[k] is not None:
            u_k = x_stage[k] @ sp.k_s[k].T + d_stage[k]
        elif sp.k_ms and sp.k_ms[k] is not None:
            u_k = _modal_rows(x_stage[k], sp.k_ms[k],
                              sp.riccati_cls[a:b]) + d_stage[k]
        else:
            u_k = torch.einsum("iab,...ib->...ia", sp.K[a:b], x_stage[k]) \
                + d_stage[k]
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
    per lane [B]."""
    s = torch.cat([z.s[..., :1] - lane_view(alpha, z.s), z.s[..., 1:]],
                  dim=-1)
    x, u = project_dynamics(sp, z.x, z.u, x0)
    y, tau, s = project_kernel(sp, z.y, z.tau, s)
    return Primal(x=x, u=u, y=y, tau=tau, s=s)


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
