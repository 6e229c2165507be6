"""Host-side evaluation of the nested risk-recursive cost of a trajectory
(a NumPy copy of :mod:`raocp_tpu.utils.evaluate`).

The reference carries the epigraph variables (tau, s) through the solver
but never surfaces the optimal cost, and its direct cost evaluator is dead
commented-out code (``costs.py:65-87``). This module computes the nested
objective

    V_i = rho_i( [ stage_cost_j + V_j ]_{j in children(i)} )
    V_leaf = x_leaf' P x_leaf
    stage_cost_j = x_i' Q_j x_i + u_i' R_j u_i       (i = parent of j)

by recursing the tree bottom-up with each node's risk measure evaluated as
an LP over its ambiguity set
(:func:`raocp_tpu_torch.core.elements.max_over_ambiguity`).
At a solution, ``V_0`` equals the solver's ``result.objective`` (the root
epigraph variable s_0) up to the convergence tolerance — an independent
end-to-end oracle of the whole conic formulation.
"""

import numpy as np

__all__ = ["risk_value", "stage_costs"]


def stage_costs(spec, x, u):
    """Per-node cost contributions: ``cost[j] = x_i'Q_j x_i + u_i'R_j u_i``
    for non-root nodes j with parent i (the cost item AT node j applied to
    the parent's state/input — reference ``operators.py:32-39`` routes
    sqrt(Q_j) x_i / sqrt(R_j) u_i the same way), and the terminal values
    ``leaf[l] = x_l' P_l x_l``. Returns (cost[num_nodes], leaf[num_leaf])."""
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    x = np.asarray(x, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    cost = np.zeros(N)
    for j in range(1, N):
        i = int(tree.ancestor_of(j))
        q = spec.nonleaf_cost_at_node(j)
        cost[j] = (x[i] @ q.state_weights @ x[i]
                   + u[i] @ q.control_weights @ u[i])
    leaf = np.zeros(N - NL)
    for li in range(N - NL):
        p = spec.leaf_cost_at_node(NL + li)
        xl = x[NL + li]
        leaf[li] = xl @ p.state_weights @ xl
    return cost, leaf


def risk_value(spec, x, u) -> float:
    """The nested risk-recursive cost V_0 of trajectory (x, u) on ``spec``.

    ``x``: [num_nodes, n] states (padded rows beyond num_nodes are
    ignored), ``u``: [num_nonleaf, m] inputs.
    """
    tree = spec.tree
    N = tree.num_nodes
    NL = tree.num_nonleaf_nodes
    cost, leaf = stage_costs(spec, x, u)
    value = np.zeros(N)
    value[NL:] = leaf
    for i in reversed(range(NL)):
        children = tree.children_of(i)
        outcome = cost[children] + value[children]
        value[i] = spec.risk_at_node(i).evaluate(outcome)
    return float(value[0])
