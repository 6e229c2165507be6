"""Primal/dual variables of the Chambolle-Pock iteration as NamedTuples of
tensors.

Each segment is one stacked, padded tensor, so every per-node operation is
a single batched op (counterpart of :mod:`raocp_tpu.core.variables`):

Primal z = (x, u, y, tau, s)  — reference segments 1..5 (``cache.py:126``)
Dual  eta = parts 1..7 (nonleaf/child) and 11..14 (leaf)
                              — reference segments (``cache.py:140``)

Padding invariant: padded slots (y/e1 columns beyond a node's real risk
rows, masked child-table entries, row 0 of the child-indexed parts
e3..e6) are identically zero at all times; every operator and prox map
preserves this, so norms and inner products match the reference exactly.

A batch of solves from B initial states (``Solver.solve_batch``) gives
every leaf a leading lane axis, [B, ...]; the ops take either layout.
"""

import math
from typing import NamedTuple

import torch

__all__ = ["Primal", "Dual", "tree_inf_norm", "tree_dot", "tree_axpy",
           "tree_scale", "tree_sub", "tree_add", "lane_view", "make_packers",
           "primal_shapes", "dual_shapes"]


class Primal(NamedTuple):
    """Stacked primal variables.

    x:   [np_pad, n]      states
    u:   [nl_pad, m]      controls
    y:   [nl_pad, Y]      risk duals (padded; Y = max risk rows)
    tau: [np_pad]         epigraph relaxation of stage costs
    s:   [np_pad]         epigraph relaxation of risk recursion
    """
    x: torch.Tensor
    u: torch.Tensor
    y: torch.Tensor
    tau: torch.Tensor
    s: torch.Tensor


class Dual(NamedTuple):
    """Stacked dual variables (conic parts of eta).

    Parts 3-6 are indexed by the *child* node (row 0 unused and zero).
    Parts 11-14 are indexed by leaf ordinal (node - num_nonleaf).

    e1:  [nl_pad, Y]       risk ambiguity dual (padded like y)
    e2:  [nl_pad]          nonnegativity of s_i - b'y_i
    e3:  [np_pad, n]       sqrt(Q_j) x_i         (SOC head)
    e4:  [np_pad, m]       sqrt(R_j) u_i         (SOC head)
    e5:  [np_pad]          tau_j / 2             (SOC head)
    e6:  [np_pad]          tau_j / 2             (SOC tail)
    e7:  [nl_pad, rows]    nonleaf constraint rows
    e11: [lf_pad, n]       sqrt(P) x_leaf        (SOC head)
    e12: [lf_pad]          s_leaf / 2            (SOC head)
    e13: [lf_pad]          s_leaf / 2            (SOC tail)
    e14: [lf_pad, rows]    leaf constraint rows
    """
    e1: torch.Tensor
    e2: torch.Tensor
    e3: torch.Tensor
    e4: torch.Tensor
    e5: torch.Tensor
    e6: torch.Tensor
    e7: torch.Tensor
    e11: torch.Tensor
    e12: torch.Tensor
    e13: torch.Tensor
    e14: torch.Tensor


def primal_shapes(sp) -> Primal:
    """The shape of each primal leaf of ``sp`` (without a lane axis)."""
    return Primal(x=(sp.np_pad, sp.n), u=(sp.nl_pad, sp.m),
                  y=(sp.nl_pad, sp.Y), tau=(sp.np_pad,), s=(sp.np_pad,))


def dual_shapes(sp) -> Dual:
    """The shape of each dual leaf of ``sp`` (without a lane axis)."""
    return Dual(e1=(sp.nl_pad, sp.Y), e2=(sp.nl_pad,), e3=(sp.np_pad, sp.n),
                e4=(sp.np_pad, sp.m), e5=(sp.np_pad,), e6=(sp.np_pad,),
                e7=(sp.nl_pad, sp.nl_rows), e11=(sp.lf_pad, sp.n),
                e12=(sp.lf_pad,), e13=(sp.lf_pad,),
                e14=(sp.lf_pad, sp.l_rows))


def make_packers(sp):
    """(pack_primal, unpack_primal, pack_dual, unpack_dual) for one problem
    (JAX ``core/variables.py:77``): the 5-leaf primal / 11-leaf dual as one
    flat vector in leaf order. A pack is one concatenation; an unpack is
    views of the flat vector. Padded slots stay zero, so packed norms equal
    the per-leaf ones."""
    p_shapes = list(primal_shapes(sp))
    d_shapes = list(dual_shapes(sp))

    def _mk(shapes, cls):
        offs = [0]
        for shape in shapes:
            offs.append(offs[-1] + math.prod(shape))

        def pack(tree):
            return torch.cat([leaf.reshape(-1) for leaf in tree])

        def unpack(vec):
            return cls(*(vec[offs[i]:offs[i + 1]].reshape(shapes[i])
                         for i in range(len(shapes))))

        return pack, unpack

    pack_p, unpack_p = _mk(p_shapes, Primal)
    pack_d, unpack_d = _mk(d_shapes, Dual)
    return pack_p, unpack_p, pack_d, unpack_d


def lane_view(a, leaf):
    """A per-lane scalar ``a`` [B] as [B, 1, ...], to broadcast against
    ``leaf`` [B, ...]; a number or a 0-d tensor as it is."""
    if not isinstance(a, torch.Tensor) or a.dim() == 0:
        return a
    return a.reshape(tuple(a.shape) + (1,) * (leaf.dim() - a.dim()))


def tree_inf_norm(tree, lanes: bool = False) -> torch.Tensor:
    """max |entry| over every leaf: a 0-d tensor, or with ``lanes`` one per
    lane of a leading lane axis, [B] (no host sync)."""
    if not lanes:
        return torch.stack([leaf.abs().max() for leaf in tree]).max()
    return torch.stack([leaf.abs().flatten(1).amax(dim=1)
                        for leaf in tree]).amax(dim=0)


def tree_dot(a, b, lanes: bool = False) -> torch.Tensor:
    """Inner product <a, b> over matching NamedTuples: a 0-d tensor, or
    with ``lanes`` one per lane of a leading lane axis, [B]."""
    if not lanes:
        return torch.stack([torch.vdot(x.reshape(-1), y.reshape(-1))
                            for x, y in zip(a, b)]).sum()
    return torch.stack([(x.flatten(1) * y.flatten(1)).sum(dim=1)
                        for x, y in zip(a, b)]).sum(dim=0)


def tree_axpy(alpha, x, y):
    """alpha * x + y (``alpha`` a number, or per lane [B])."""
    return type(x)(*(lane_view(alpha, xi) * xi + yi for xi, yi in zip(x, y)))


def tree_scale(alpha, x):
    return type(x)(*(lane_view(alpha, xi) * xi for xi in x))


def tree_sub(a, b):
    return type(a)(*(x - y for x, y in zip(a, b)))


def tree_add(a, b):
    return type(a)(*(x + y for x, y in zip(a, b)))
