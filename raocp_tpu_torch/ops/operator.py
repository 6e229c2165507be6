"""The Chambolle-Pock linear operator L and its adjoint L' on tensors
(counterpart of :mod:`raocp_tpu.ops.operator`).

Each is one batched computation over the stacked variables: parent
expansions, stage-stacked mode-block contractions, and child reductions —
no per-node control flow. The variables may carry a leading lane axis
([B, rows, ...], a batch of solves); the problem's tables have none and
broadcast.

Mathematical definition (per nonleaf node i, child j, leaf l):
  eta1_i = y_i                       eta2_i = s_i - b_i'y_i
  eta3_j = sqrt(Q_j) x_i             eta4_j = sqrt(R_j) u_i
  eta5_j = eta6_j = tau_j / 2        eta7_i = [x_i; u_i]   (box rows)
  eta11_l = sqrt(P) x_l              eta12_l = eta13_l = s_l / 2
  eta14_l = x_l
and ell_t is the exact adjoint.
"""

import torch
import torch.distributed as dist

from raocp_tpu_torch.core.stacked import StackedProblem
from raocp_tpu_torch.core.variables import Dual, Primal
from raocp_tpu_torch.parallel.sharding import all_reduce

__all__ = ["ell", "ell_t", "flat_linops", "sum_over_children",
           "parent_expand", "repad", "stage_groups"]


def stage_groups(sp: StackedProblem, same):
    """Yield (k0, k1) maximal runs of consecutive nonleaf stages with
    ``same(k0, k) for k in (k0, k1)``.

    Stage-major node ordering makes a run's parents [ss[k0], ss[k1]) and
    children [ss[k0+1], ss[k1+1]) contiguous, so a per-stage batched op
    whose parameters coincide across the run applies to the whole run as
    one op."""
    ns = sp.num_stages - 1
    k = 0
    while k < ns:
        k1 = k + 1
        while k1 < ns and same(k, k1):
            k1 += 1
        yield k, k1
        k = k1


def _same_weight(table):
    """Group predicate: stages share one (non-None) stage-stacked block
    tensor (build_stacked shares one per distinct pattern)."""
    return lambda k0, k: table[k0] is not None and table[k] is table[k0]


def _same_child(sp: StackedProblem):
    """Group predicate: stages have the same uniform child count."""
    return lambda k0, k: (sp.stage_child[k0] is not None
                          and sp.stage_child[k] == sp.stage_child[k0])


def _frontier_psum(sp: StackedProblem, k0: int, part):
    """Complete a child reduction across the subtree-partition frontier
    (JAX ``ops/operator.py:63``).

    Under the replicated-spine partition (parallel.subtree) the children of
    stage ``frontier - 1`` are split over the ranks, so a per-parent child
    reduction computed on a rank is partial (each rank adds the children it
    owns; its mask is zero on the others): one all-reduce over the group
    completes it, the same on every rank. Every other stage reduces
    rank-locally. The identity outside a partition."""
    if sp.frontier is not None and k0 == sp.frontier - 1:
        return all_reduce(part.contiguous(), dist.ReduceOp.SUM,
                          sp.spmd_group)
    return part


def _child_rel(sp: StackedProblem, a: int, b: int, a2: int, b2: int):
    """Stage-relative child indices of parents [a, b) into the child slice
    [a2, b2), clamped so the 0-padded entries of ``child_idx`` stay in
    range (torch raises on out-of-range gathers; the masked slots are
    multiplied by 0 afterwards)."""
    return torch.clamp(sp.child_idx[a:b] - a2, 0, b2 - a2 - 1)


def repad(arr, rows: int, dim: int = 0):
    """Pad axis ``dim`` with zeros up to ``rows`` (no-op when already
    there)."""
    extra = rows - arr.shape[dim]
    if extra == 0:
        return arr
    shape = list(arr.shape)
    shape[dim] = extra
    return torch.cat([arr, arr.new_zeros(shape)], dim=dim)


def sum_over_children(sp: StackedProblem, w):
    """[..., np_pad, F] child-indexed rows -> [..., nl_pad, F] sums over
    each node's children. Uniform stages reshape ``[..., W, c, F] ->
    sum(dim=-2)``; ragged stages gather through the padded child table."""
    ss = sp.stage_start
    lead = tuple(w.shape[:-2])
    F = w.shape[-1]
    parts = []
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        wk = w[..., a2:b2, :]
        c = sp.stage_child[k0]
        if c is not None:
            parts.append(wk.reshape(lead + (b - a, c, F)).sum(dim=-2))
        else:                      # single ragged stage (k1 == k0 + 1)
            rel = _child_rel(sp, a, b, a2, b2)
            mask = sp.child_mask[a:b][..., None]
            parts.append(_frontier_psum(
                sp, k0, torch.sum(wk[..., rel, :] * mask, dim=-2)))
    tail = sp.nl_pad - sp.num_nonleaf
    if tail:
        parts.append(w.new_zeros(lead + (tail, F)))
    return torch.cat(parts, dim=-2)


def parent_expand(sp: StackedProblem, v, rows: int):
    """[..., nonleaf-or-node rows, F] -> [..., rows, F] with out[j] =
    v[anc(j)] for real non-root nodes j, zero at row 0 and padding."""
    ss = sp.stage_start
    lead = tuple(v.shape[:-2])
    F = v.shape[-1]
    parts = [v.new_zeros(lead + (1, F))]
    for k0, k1 in stage_groups(sp, _same_child(sp)):
        a, b = ss[k0], ss[k1]
        a2, b2 = ss[k0 + 1], ss[k1 + 1]
        c = sp.stage_child[k0]
        if c is not None:
            parts.append(torch.repeat_interleave(v[..., a:b, :], c, dim=-2))
        else:                      # single ragged stage
            parts.append(v[..., sp.anc[a2:b2], :])
    tail = rows - ss[sp.num_stages]
    if tail:
        parts.append(v.new_zeros(lead + (tail, F)))
    return torch.cat(parts, dim=-2)


def ell(sp: StackedProblem, z: Primal) -> Dual:
    """Apply L: primal -> dual (parity: reference ``operators.py:19-53``).
    Every leaf may carry leading lane dims; the tables broadcast. On a
    rank's block of the flat partition, :func:`_flat_ell`."""
    if sp.flat is not None:
        return _flat_ell(sp, z)
    NL, N, n = sp.num_nonleaf, sp.num_nodes, sp.n
    lead = tuple(z.x.shape[:-2])
    # one fused [x; u] per nonleaf node feeds the parent-expand, the
    # blockdiag(sqrtQ, sqrtR) matvec, and the constraint rows e7
    xu = torch.cat([repad(z.x[..., :NL, :], sp.nl_pad, -2), z.u], dim=-1)
    e1 = z.y
    e2 = repad(z.s[..., :NL], sp.nl_pad, -1) \
        - torch.sum(sp.b_pad * z.y, dim=-1)
    if sp.QRm is not None and any(w is not None for w in sp.qr_fwd):
        # stage-stacked mode blocks: parent-expand + modal matvec + mode
        # select as one contraction per group of stages sharing the block
        ss = sp.stage_start
        F = sp.n + sp.m
        parts = [xu.new_zeros(lead + (1, F))]              # root row
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_fwd)):
            a, b = ss[k0], ss[k1]
            a2, b2 = ss[k0 + 1], ss[k1 + 1]
            if sp.qr_fwd[k0] is not None:
                e3d = torch.tensordot(xu[..., a:b, :], sp.qr_fwd[k0],
                                      dims=([-1], [0]))    # [..., W, c, F]
                parts.append(e3d.reshape(lead + (b2 - a2, F)))
            else:                  # single non-uniform stage (k1 == k0 + 1)
                c = sp.stage_child[k0]
                xu_par = (torch.repeat_interleave(xu[..., a:b, :], c, dim=-2)
                          if c is not None
                          else xu[..., sp.anc[a2:b2], :])
                parts.append(sp.QRm.slice_rows(a2, b2).matvec(xu_par))
        tail = sp.np_pad - N
        if tail:
            parts.append(xu.new_zeros(lead + (tail, F)))
        e34 = torch.cat(parts, dim=-2)
        e3, e4 = e34[..., :n], e34[..., n:]
    elif sp.QRm is not None:
        xu_parent = parent_expand(sp, xu, sp.np_pad)   # [N, n+m] (row 0 = 0)
        e34 = sp.QRm.matvec(xu_parent)
        e3, e4 = e34[..., :n], e34[..., n:]
    else:
        e3 = sp.sqrtQ.matvec(parent_expand(sp, z.x, sp.np_pad))
        e4 = sp.sqrtR.matvec(parent_expand(sp, z.u, sp.np_pad))
    half_tau = 0.5 * z.tau * sp.nz_mask
    # constraint rows: G [x; u] under a shared Polyhedral matrix, or the
    # identity rows of Rectangle/Ball
    e7 = ((xu @ sp.nl_G.T) if sp.nl_G is not None else xu) \
        * sp.nl_active[:, None]

    x_leaf = repad(z.x[..., NL:N, :], sp.lf_pad, -2)
    e11 = sp.sqrtP.matvec(x_leaf)
    half_s = 0.5 * repad(z.s[..., NL:N], sp.lf_pad, -1)
    e14 = ((x_leaf @ sp.l_G.T) if sp.l_G is not None else x_leaf) \
        * sp.l_active[:, None]

    return Dual(e1=e1, e2=e2, e3=e3, e4=e4, e5=half_tau, e6=half_tau,
                e7=e7, e11=e11, e12=half_s, e13=half_s, e14=e14)


def ell_t(sp: StackedProblem, eta: Dual) -> Primal:
    """Apply L' (exact adjoint of :func:`ell`; parity: reference
    ``operators.py:55-94``). Every leaf may carry leading lane dims. On a
    rank's block of the flat partition, :func:`_flat_ell_t`."""
    if sp.flat is not None:
        return _flat_ell_t(sp, eta)
    NL, LF = sp.num_nonleaf, sp.num_leaf
    n = sp.n
    lead = tuple(eta.e3.shape[:-2])

    y = eta.e1 - sp.b_pad * eta.e2[..., None]

    con7 = eta.e7 * sp.nl_active[:, None]
    if sp.nl_G is not None:
        con7 = con7 @ sp.nl_G

    # x/u contributions from the SOC heads, summed back over children
    if sp.QRm is not None and any(w is not None for w in sp.qr_bwd):
        ss = sp.stage_start
        F = sp.n + sp.m
        e34 = torch.cat([eta.e3, eta.e4], dim=-1)
        parts = []
        for k0, k1 in stage_groups(sp, _same_weight(sp.qr_bwd)):
            a, b = ss[k0], ss[k1]
            a2, b2 = ss[k0 + 1], ss[k1 + 1]
            blk = e34[..., a2:b2, :]
            c = sp.stage_child[k0]
            if sp.qr_bwd[k0] is not None:
                parts.append(torch.tensordot(
                    blk.reshape(lead + (b - a, c, F)), sp.qr_bwd[k0],
                    dims=([-2, -1], [0, 1])))
            else:                  # single non-uniform stage (k1 == k0 + 1)
                w = sp.QRm.slice_rows(a2, b2).rmatvec(blk)
                if c is not None:
                    part = w.reshape(lead + (b - a, c, F)).sum(dim=-2)
                else:
                    rel = _child_rel(sp, a, b, a2, b2)
                    mask = sp.child_mask[a:b][..., None]
                    part = torch.sum(w[..., rel, :] * mask, dim=-2)
                parts.append(_frontier_psum(sp, k0, part))
        tail = sp.nl_pad - NL
        if tail:
            parts.append(e34.new_zeros(lead + (tail, F)))
        s34 = torch.cat(parts, dim=-2)
        xu = con7 + s34
        x_nl, u = xu[..., :n], xu[..., n:]
    elif sp.QRm is not None:
        w34 = sp.QRm.rmatvec(torch.cat([eta.e3, eta.e4], dim=-1))
        s34 = sum_over_children(sp, w34)
        xu = con7 + s34
        x_nl, u = xu[..., :n], xu[..., n:]
    else:
        w3 = sp.sqrtQ.rmatvec(eta.e3)                # sqrtQ' e3 per child
        w4 = sp.sqrtR.rmatvec(eta.e4)
        x_nl = con7[..., :n] + sum_over_children(sp, w3)
        u = con7[..., n:] + sum_over_children(sp, w4)

    con14 = eta.e14 * sp.l_active[:, None]
    if sp.l_G is not None:
        con14 = con14 @ sp.l_G
    x_leaf = sp.sqrtP.rmatvec(eta.e11) + con14
    x = repad(torch.cat([x_nl[..., :NL, :], x_leaf[..., :LF, :]], dim=-2),
              sp.np_pad, -2)

    tau = 0.5 * (eta.e5 + eta.e6) * sp.nz_mask
    s = repad(torch.cat([eta.e2[..., :NL],
                         (0.5 * (eta.e12 + eta.e13))[..., :LF]], dim=-1),
              sp.np_pad, -1)

    return Primal(x=x, u=u, y=y, tau=tau, s=s)


# -- the flat partition: a rank's rows of each stage op, completed with the
#    halo rows of parallel.flat's planned windows -----------------------------

def _flat_parent_span(sp: StackedProblem, k0: int, ca: int, cb: int):
    """(p0, p1, off): the whole parents [p0, p1) of the rows [ca, cb) of
    uniform stage group ``k0``'s children, and the offset of row ``ca``
    among those parents' children (stage-major: a group's children are its
    parents' in order, ``c`` each)."""
    c = sp.stage_child[k0]
    a, a2 = sp.stage_start[k0], sp.stage_start[k0 + 1]
    p0 = a + (ca - a2) // c
    return p0, a + (cb - 1 - a2) // c + 1, ca - a2 - (p0 - a) * c


def _flat_parent_rows(sp: StackedProblem, k0: int, win, w_lo: int, ca: int,
                      cb: int, anc):
    """Each of the rows [ca, cb) of stage group ``k0``'s children gets its
    parent's row of ``win`` (a window of parent rows from global row
    ``w_lo``). Uniform groups repeat whole parents and cut the halo
    children off both ends; a ragged stage gathers through ``anc`` (the
    children's global parent ids)."""
    c = sp.stage_child[k0]
    if c is None:
        return win[..., anc - w_lo, :]
    p0, p1, off = _flat_parent_span(sp, k0, ca, cb)
    rep = torch.repeat_interleave(win[..., p0 - w_lo:p1 - w_lo, :], c,
                                  dim=-2)
    return rep[..., off:off + cb - ca, :]


def _flat_stacked_rows(sp: StackedProblem, k0: int, win, w_lo: int, ca: int,
                       cb: int, table):
    """Rows [ca, cb) of the children of stage group ``k0`` through its
    stage-stacked block ``table`` [F, c, G] (one contraction over the
    group's whole parents in ``win``, the halo children cut off)."""
    p0, p1, off = _flat_parent_span(sp, k0, ca, cb)
    rows = torch.tensordot(win[..., p0 - w_lo:p1 - w_lo, :], table,
                           dims=([-1], [0]))
    rows = rows.reshape(tuple(rows.shape[:-3]) + (-1, rows.shape[-1]))
    return rows[..., off:off + cb - ca, :]


def _flat_reduce(sp: StackedProblem, k0: int, w, pa: int, pb: int, ca: int):
    """Per-parent sums of ``w`` (the child rows of this rank's nonleaf rows
    [pa, pb) of stage group ``k0``, from global row ``ca``)."""
    c = sp.stage_child[k0]
    if c is not None:
        return w.reshape(tuple(w.shape[:-2]) + (pb - pa, c, w.shape[-1])) \
            .sum(dim=-2)
    q0 = sp.flat.start["nl"]
    rel = torch.clamp(sp.child_idx[pa - q0:pb - q0] - ca, 0,
                      w.shape[-2] - 1)
    mask = sp.child_mask[pa - q0:pb - q0][..., None]
    return torch.sum(w[..., rel, :] * mask, dim=-2)


def _flat_own_parents(sp: StackedProblem, same):
    """(k0, k1, pa, pb, ca, cb) for each stage group of ``same`` in which
    this rank owns nonleaf rows [pa, pb), whose children are [ca, cb)."""
    fp = sp.flat
    lo, hi = fp.real["nl"]
    ss = sp.stage_start
    for k0, k1 in stage_groups(sp, same):
        pa, pb = max(ss[k0], lo), min(ss[k1], hi)
        if pa < pb:
            yield (k0, k1, pa, pb) + fp.children(pa, pb)


def _flat_own_children(sp: StackedProblem, same, lo: int, hi: int):
    """(k0, ca, cb) for each stage group of ``same`` whose children meet
    the all-node rows [lo, hi) in [ca, cb)."""
    ss = sp.stage_start
    for k0, k1 in stage_groups(sp, same):
        ca, cb = max(ss[k0 + 1], lo), min(ss[k1 + 1], hi)
        if ca < cb:
            yield k0, ca, cb


def _flat_sum_children(sp: StackedProblem, w, w_lo: int):
    """[..., nl block, F] sums over the children of this rank's nonleaf
    rows, from ``w`` (their child rows, from global row ``w_lo``)."""
    parts = [_flat_reduce(sp, k0, w[..., ca - w_lo:cb - w_lo, :], pa, pb, ca)
             for k0, _, pa, pb, ca, cb in _flat_own_parents(
                 sp, _same_child(sp))]
    lead = tuple(w.shape[:-2])
    out = torch.cat(parts, dim=-2) if parts \
        else w.new_zeros(lead + (0, w.shape[-1]))
    return repad(out, sp.nl_pad, -2)


def _flat_parent_expand(sp: StackedProblem, win, w_lo: int):
    """[..., np block, F]: each real non-root row of this rank's all-node
    block gets its parent's row of ``win``; zero at the root and ghosts."""
    fp = sp.flat
    lo, hi = fp.child_rows
    p0 = fp.start["np"]
    lead, F = tuple(win.shape[:-2]), win.shape[-1]
    parts = [win.new_zeros(lead + (lo - p0, F))]
    for k0, ca, cb in _flat_own_children(sp, _same_child(sp), lo, hi):
        parts.append(_flat_parent_rows(sp, k0, win, w_lo, ca, cb,
                                       sp.anc[ca - p0:cb - p0]))
    return repad(torch.cat(parts, dim=-2), sp.np_pad, -2)


def _flat_ell(sp: StackedProblem, z: Primal) -> Dual:
    """L on a rank's blocks of the flat partition: one exchange brings the
    nonleaf and leaf views of [x | s] and the parents' x and u of the
    rank's rows; the rest is :func:`ell`'s arithmetic on those rows."""
    fp = sp.flat
    n = sp.n
    lead = tuple(z.x.shape[:-2])
    xs = torch.cat([z.x, z.s[..., None]], dim=-1)
    xs_nl, xs_lf, px, pu = fp.exchange(
        sp, [("np>nl", xs), ("np>lf", xs), ("np>par", z.x), ("nl>par", z.u)])
    xs_nl = repad(xs_nl, sp.nl_pad, -2)
    xs_lf = repad(xs_lf, sp.lf_pad, -2)
    xu = torch.cat([xs_nl[..., :n], z.u], dim=-1)
    e2 = xs_nl[..., n] - torch.sum(sp.b_pad * z.y, dim=-1)
    # parents' [x; u] of this rank's real non-root rows
    par = torch.cat([px, pu], dim=-1)
    w_lo = fp.window("nl>par")[0]
    if sp.QRm is not None and any(w is not None for w in sp.qr_fwd):
        lo, hi = fp.child_rows
        p0 = fp.start["np"]
        F = sp.n + sp.m
        parts = [par.new_zeros(lead + (lo - p0, F))]
        for k0, ca, cb in _flat_own_children(sp, _same_weight(sp.qr_fwd),
                                             lo, hi):
            if sp.qr_fwd[k0] is not None:
                parts.append(_flat_stacked_rows(sp, k0, par, w_lo, ca, cb,
                                                sp.qr_fwd[k0]))
            else:
                xu_par = _flat_parent_rows(sp, k0, par, w_lo, ca, cb,
                                           sp.anc[ca - p0:cb - p0])
                parts.append(sp.QRm.slice_rows(ca - p0, cb - p0)
                             .matvec(xu_par))
        e34 = repad(torch.cat(parts, dim=-2), sp.np_pad, -2)
        e3, e4 = e34[..., :n], e34[..., n:]
    else:
        xu_parent = _flat_parent_expand(sp, par, w_lo)
        if sp.QRm is not None:
            e34 = sp.QRm.matvec(xu_parent)
            e3, e4 = e34[..., :n], e34[..., n:]
        else:
            e3 = sp.sqrtQ.matvec(xu_parent[..., :n])
            e4 = sp.sqrtR.matvec(xu_parent[..., n:])
    half_tau = 0.5 * z.tau * sp.nz_mask
    e7 = ((xu @ sp.nl_G.T) if sp.nl_G is not None else xu) \
        * sp.nl_active[:, None]
    x_leaf = xs_lf[..., :n]
    e11 = sp.sqrtP.matvec(x_leaf)
    half_s = 0.5 * xs_lf[..., n]
    e14 = ((x_leaf @ sp.l_G.T) if sp.l_G is not None else x_leaf) \
        * sp.l_active[:, None]
    return Dual(e1=z.y, e2=e2, e3=e3, e4=e4, e5=half_tau, e6=half_tau,
                e7=e7, e11=e11, e12=half_s, e13=half_s, e14=e14)


def _flat_ell_t(sp: StackedProblem, eta: Dual) -> Primal:
    """L' on a rank's blocks of the flat partition: one exchange brings the
    children's e3 / e4 rows of the rank's nonleaf rows, a second one the
    nonleaf and leaf parts of x and s back to the all-node block."""
    fp = sp.flat
    n = sp.n
    tables = fp.tables
    e34 = torch.cat([eta.e3, eta.e4], dim=-1)
    (cw,) = fp.exchange(sp, [("np>child", e34)])
    c_lo = fp.window("np>child")[0]
    y = eta.e1 - sp.b_pad * eta.e2[..., None]
    con7 = eta.e7 * sp.nl_active[:, None]
    if sp.nl_G is not None:
        con7 = con7 @ sp.nl_G
    if sp.QRm is not None and any(w is not None for w in sp.qr_bwd):
        parts = []
        for k0, _, pa, pb, ca, cb in _flat_own_parents(
                sp, _same_weight(sp.qr_bwd)):
            blk = cw[..., ca - c_lo:cb - c_lo, :]
            if sp.qr_bwd[k0] is not None:
                c = sp.stage_child[k0]
                parts.append(torch.tensordot(
                    blk.reshape(tuple(blk.shape[:-2]) + (pb - pa, c, -1)),
                    sp.qr_bwd[k0], dims=([-2, -1], [0, 1])))
            else:
                w = tables["QRm_c"].slice_rows(ca - c_lo, cb - c_lo) \
                    .rmatvec(blk)
                parts.append(_flat_reduce(sp, k0, w, pa, pb, ca))
        lead = tuple(cw.shape[:-2])
        s34 = repad(torch.cat(parts, dim=-2) if parts
                    else cw.new_zeros(lead + (0, cw.shape[-1])),
                    sp.nl_pad, -2)
    elif sp.QRm is not None:
        s34 = _flat_sum_children(sp, tables["QRm_c"].rmatvec(cw), c_lo)
    else:
        s34 = torch.cat([
            _flat_sum_children(sp, tables["sqrtQ_c"].rmatvec(cw[..., :n]),
                               c_lo),
            _flat_sum_children(sp, tables["sqrtR_c"].rmatvec(cw[..., n:]),
                               c_lo)], dim=-1)
    xu = con7 + s34
    x_nl, u = xu[..., :n], xu[..., n:]
    con14 = eta.e14 * sp.l_active[:, None]
    if sp.l_G is not None:
        con14 = con14 @ sp.l_G
    x_leaf = sp.sqrtP.rmatvec(eta.e11) + con14
    s_leaf = 0.5 * (eta.e12 + eta.e13)
    w_nl, w_lf = fp.exchange(sp, [
        ("nl>np", torch.cat([x_nl, eta.e2[..., None]], dim=-1)),
        ("lf>np", torch.cat([x_leaf, s_leaf[..., None]], dim=-1))])
    xs = repad(torch.cat([w_nl, w_lf], dim=-2), sp.np_pad, -2)
    tau = 0.5 * (eta.e5 + eta.e6) * sp.nz_mask
    return Primal(x=xs[..., :n], u=u, y=y, tau=tau, s=xs[..., n])


def flat_linops(sp: StackedProblem):
    """(matvec, rmatvec, primal_dim, dual_dim) on flat NumPy vectors (JAX
    ``ops/operator.py:274``; parity: reference ``operators.py:96-109``).
    Each call uploads the vector to the problem's device, applies L or L',
    and returns a float64 NumPy vector, so the pair plugs into
    ``scipy.sparse.linalg.LinearOperator``::

        mv, rmv, np_, nd = flat_linops(sp)
        L = LinearOperator((nd, np_), matvec=mv, rmatvec=rmv)
    """
    import numpy as np

    from raocp_tpu_torch.core.variables import make_packers

    pack_p, unpack_p, pack_d, unpack_d = make_packers(sp)
    primal_dim = int(pack_p(sp.zero_primal()).shape[0])
    dual_dim = int(pack_d(sp.zero_dual()).shape[0])

    def upload(vec):
        return torch.as_tensor(np.asarray(vec, dtype=np.float64).reshape(-1),
                               dtype=sp.dtype, device=sp.device)

    def matvec(vec):
        out = pack_d(ell(sp, unpack_p(upload(vec))))
        return out.cpu().numpy().astype(np.float64)

    def rmatvec(vec):
        out = pack_p(ell_t(sp, unpack_d(upload(vec))))
        return out.cpu().numpy().astype(np.float64)

    return matvec, rmatvec, primal_dim, dual_dim
