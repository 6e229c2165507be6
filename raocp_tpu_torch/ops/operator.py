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

from raocp_tpu_torch.core.stacked import StackedProblem
from raocp_tpu_torch.core.variables import Dual, Primal

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
            parts.append(torch.sum(wk[..., rel, :] * mask, dim=-2))
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
    Every leaf may carry leading lane dims; the tables broadcast."""
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
    ``operators.py:55-94``). Every leaf may carry leading lane dims."""
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
                    parts.append(w.reshape(lead + (b - a, c, F)).sum(dim=-2))
                else:
                    rel = _child_rel(sp, a, b, a2, b2)
                    mask = sp.child_mask[a:b][..., None]
                    parts.append(torch.sum(w[..., rel, :] * mask, dim=-2))
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
