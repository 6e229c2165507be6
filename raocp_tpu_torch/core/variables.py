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
"""

from typing import NamedTuple

import torch

__all__ = ["Primal", "Dual", "tree_inf_norm", "tree_dot", "tree_axpy",
           "tree_scale", "tree_sub", "tree_add"]


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


def tree_inf_norm(tree) -> torch.Tensor:
    """max |entry| over every leaf (a 0-d tensor; no host sync)."""
    return torch.stack([leaf.abs().max() for leaf in tree]).max()


def tree_dot(a, b) -> torch.Tensor:
    """Inner product <a, b> over matching NamedTuples (a 0-d tensor)."""
    return torch.stack([torch.vdot(x.reshape(-1), y.reshape(-1))
                        for x, y in zip(a, b)]).sum()


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return type(x)(*(alpha * xi + yi for xi, yi in zip(x, y)))


def tree_scale(alpha, x):
    return type(x)(*(alpha * xi for xi in x))


def tree_sub(a, b):
    return type(a)(*(x - y for x, y in zip(a, b)))


def tree_add(a, b):
    return type(a)(*(x + y for x, y in zip(a, b)))
