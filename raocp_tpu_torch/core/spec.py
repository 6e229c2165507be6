"""RAOCP problem specification: the fluent builder.

Capability parity with the reference builder (``raocp/core/raocp_spec.py:6``):
same method names, Markovian-indexing semantics, all-node broadcasting, the
dynamics-before-constraints rule and per-node risk realization. The internals
are redesigned for scale: instead of per-node Python object lists, each
element family is stored as a tiny table of *distinct* instances plus an
int index per node (:class:`_NodeTable`), so assigning a Markovian family to
a 10^5-node tree touches O(modes) objects and one vectorized index scatter.
:mod:`raocp_tpu_torch.core.stacked` materializes the tables into padded device
arrays for the batched solver.
"""

from copy import deepcopy

import numpy as np

import raocp_tpu_torch.core.constraints as core_constraints
import raocp_tpu_torch.core.tree as core_tree

__all__ = ["RAOCP"]


class _NodeTable:
    """Element-per-node storage as (distinct items, int index per node).

    Slot 0 is the unassigned marker (item None), so a fresh table reads as
    all-None without allocating anything per node.
    """

    def __init__(self, num_nodes: int):
        self._items = [None]
        self._index = np.zeros(num_nodes, dtype=np.int64)

    def fill(self, item, start: int, stop: int) -> None:
        """Assign one shared item to the node range [start, stop)."""
        self._items.append(item)
        self._index[start:stop] = len(self._items) - 1

    def scatter(self, items, mode_of_node: np.ndarray, start: int,
                stop: int) -> None:
        """Assign ``items[mode_of_node[i]]`` to each node i in the range."""
        base = len(self._items)
        self._items.extend(items)
        self._index[start:stop] = base + np.asarray(
            mode_of_node[start:stop], dtype=np.int64)

    def at(self, node: int):
        return self._items[self._index[node]]

    def to_list(self) -> list:
        return [self._items[slot] for slot in self._index]

    @property
    def assigned(self) -> bool:
        return len(self._items) > 1


class RAOCP:
    """Fluent builder for a risk-averse optimal control problem on a tree."""

    def __init__(self, scenario_tree: core_tree.ScenarioTree):
        self._tree = scenario_tree
        num_nodes = scenario_tree.num_nodes
        num_nonleaf = scenario_tree.num_nonleaf_nodes
        self._dynamics = _NodeTable(num_nodes)
        self._nonleaf_costs = _NodeTable(num_nodes)
        self._leaf_costs = _NodeTable(num_nodes)
        self._nonleaf_constraints = _NodeTable(num_nodes)
        self._leaf_constraints = _NodeTable(num_nodes)
        self._risks = _NodeTable(num_nonleaf)
        # free by default: one shared inactive constraint per node class
        self._nonleaf_constraints.fill(core_constraints.No(), 0, num_nonleaf)
        self._leaf_constraints.fill(core_constraints.No(), num_nonleaf,
                                    num_nodes)

    # -- accessors -----------------------------------------------------------

    @property
    def tree(self) -> core_tree.ScenarioTree:
        return self._tree

    def state_dynamics_at_node(self, node: int) -> np.ndarray:
        return self._dynamics.at(node).state_dynamics

    def control_dynamics_at_node(self, node: int) -> np.ndarray:
        return self._dynamics.at(node).control_dynamics

    def nonleaf_cost_at_node(self, node: int):
        return self._nonleaf_costs.at(node)

    def leaf_cost_at_node(self, node: int):
        return self._leaf_costs.at(node)

    def nonleaf_constraint_at_node(self, node: int):
        return self._nonleaf_constraints.at(node)

    def leaf_constraint_at_node(self, node: int):
        return self._leaf_constraints.at(node)

    def risk_at_node(self, node: int):
        return self._risks.at(node)

    @property
    def state_size(self) -> int:
        return self._dynamics.at(1).state_size

    @property
    def control_size(self) -> int:
        return self._dynamics.at(1).control_size

    # reference-compatible materialized views (cheap: lists of shared refs)

    @property
    def list_of_dynamics(self) -> list:
        return self._dynamics.to_list()

    @property
    def list_of_nonleaf_costs(self) -> list:
        return self._nonleaf_costs.to_list()

    @property
    def list_of_leaf_costs(self) -> list:
        return self._leaf_costs.to_list()

    @property
    def list_of_nonleaf_constraints(self) -> list:
        return self._nonleaf_constraints.to_list()

    @property
    def list_of_leaf_constraints(self) -> list:
        return self._leaf_constraints.to_list()

    @property
    def list_of_risks(self) -> list:
        return self._risks.to_list()

    # -- dynamics ---------------------------------------------------------------

    def with_markovian_dynamics(self, ordered_list_of_dynamics):
        """Give node i the dynamics of its disturbance mode w(i)."""
        shapes = {(d.state_dynamics.shape, d.control_dynamics.shape)
                  for d in ordered_list_of_dynamics}
        if len(shapes) > 1:
            raise ValueError("all Markovian dynamics modes must share one "
                             "(A, B) shape pair; got " + str(sorted(shapes)))
        if not self._tree.is_markovian:
            raise TypeError("Markovian dynamics need a Markovian scenario "
                            "tree")
        self._dynamics.scatter(list(ordered_list_of_dynamics),
                               self._tree.w_values, 1, self._tree.num_nodes)
        return self

    # -- costs ------------------------------------------------------------------

    def with_markovian_nonleaf_costs(self, ordered_list_of_costs):
        """Give node i the nonleaf cost of its disturbance mode w(i)."""
        for cost in ordered_list_of_costs:
            if not cost.node_type.is_nonleaf:
                raise ValueError("Markovian nonleaf costs must carry the "
                                 "Nonleaf() tag")
        if not self._tree.is_markovian:
            raise TypeError("Markovian costs need a Markovian scenario tree")
        self._nonleaf_costs.scatter(list(ordered_list_of_costs),
                                    self._tree.w_values, 1,
                                    self._tree.num_nodes)
        return self

    def with_all_nonleaf_costs(self, cost):
        """One shared cost on every node that has children."""
        if not cost.node_type.is_nonleaf:
            raise ValueError("cost for nonleaf nodes must carry the "
                             "Nonleaf() tag")
        self._nonleaf_costs.fill(cost, 1, self._tree.num_nodes)
        return self

    def with_all_leaf_costs(self, cost):
        """One shared terminal cost on every leaf."""
        if not cost.node_type.is_leaf:
            raise ValueError("cost for leaf nodes must carry the Leaf() tag")
        self._leaf_costs.fill(cost, self._tree.num_nonleaf_nodes,
                              self._tree.num_nodes)
        return self

    # -- constraints --------------------------------------------------------------

    def _dimensions_or_raise(self):
        if not self._dynamics.assigned:
            raise ValueError("dynamics must be set before constraints — the "
                             "builder binds constraint dimensions from the "
                             "(A, B) shapes")
        return self.state_size, self.control_size

    def with_all_nonleaf_constraints(self, nonleaf_constraint):
        """One shared constraint on the stacked [x; u] of every nonleaf."""
        n, m = self._dimensions_or_raise()
        if not nonleaf_constraint.node_type.is_nonleaf:
            raise ValueError("constraint for nonleaf nodes must carry the "
                             "Nonleaf() tag")
        nonleaf_constraint.bind(n, m)
        self._nonleaf_constraints.fill(nonleaf_constraint, 0,
                                       self._tree.num_nonleaf_nodes)
        return self

    def with_all_leaf_constraints(self, leaf_constraint):
        """One shared constraint on the state x of every leaf."""
        n, _ = self._dimensions_or_raise()
        if not leaf_constraint.node_type.is_leaf:
            raise ValueError("constraint for leaf nodes must carry the "
                             "Leaf() tag")
        leaf_constraint.bind(n)
        self._leaf_constraints.fill(leaf_constraint,
                                    self._tree.num_nonleaf_nodes,
                                    self._tree.num_nodes)
        return self

    # -- risks ----------------------------------------------------------------------

    def _realize_risks(self, risk_of_node):
        """Realize ``risk_of_node(i)`` per nonleaf node with that node's
        conditional child probabilities. Nodes whose (declared risk,
        probability vector) pairs coincide share one realized instance, so
        a Markov-chain tree carries O(modes * modes) realized risks rather
        than O(nodes)."""
        tree = self._tree
        realized: dict = {}
        slots = np.empty(tree.num_nonleaf_nodes, dtype=np.int64)
        items = []
        for i in range(tree.num_nonleaf_nodes):
            risk = risk_of_node(i)
            pi = np.asarray(tree.conditional_probabilities_of_children(i))
            key = (id(risk), pi.tobytes())
            slot = realized.get(key)
            if slot is None:
                node_risk = deepcopy(risk)
                node_risk.probs = pi
                slot = len(items)
                items.append(node_risk)
                realized[key] = slot
            slots[i] = slot
        self._risks.scatter(items, slots, 0, tree.num_nonleaf_nodes)
        return self

    def with_all_risks(self, risk):
        """Realize one shared risk measure per nonleaf node (each node's
        copy gets that node's conditional child probabilities)."""
        if not getattr(risk, "is_risk", False):
            raise ValueError("with_all_risks needs a risk measure "
                             "(e.g. AVaR)")
        return self._realize_risks(lambda i: risk)

    def with_stage_risks(self, ordered_list_of_risks):
        """One risk measure per nonleaf stage (node i gets the risk of its
        stage). A capability beyond the reference's single shared risk:
        e.g. worst-case near the root, expectation toward the horizon.
        The list must have one entry per nonleaf stage."""
        tree = self._tree
        ns_nl = tree.num_stages - 1
        risks = list(ordered_list_of_risks)
        if len(risks) != ns_nl:
            raise ValueError(f"need one risk per nonleaf stage ({ns_nl}), "
                             f"got {len(risks)}")
        for risk in risks:
            if not getattr(risk, "is_risk", False):
                raise ValueError("with_stage_risks needs risk measures "
                                 "(e.g. AVaR)")
        return self._realize_risks(lambda i: risks[int(tree.stage_of(i))])

    # -- display ---------------------------------------------------------------------

    def __str__(self) -> str:
        return (f"RAOCP\n+ Nodes: {self._tree.num_nodes}\n"
                f"+ {self.nonleaf_cost_at_node(0)}\n"
                f"+ {self.risk_at_node(0)}")

    def __repr__(self) -> str:
        return (f"RAOCP with {self._tree.num_nodes} nodes, with root cost: "
                f"{type(self.nonleaf_cost_at_node(0)).__name__}, with root "
                f"risk: {type(self.risk_at_node(0)).__name__}.")
