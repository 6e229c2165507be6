"""Scenario-tree topology for RAOCPs, stored as flat stage-major arrays.

Capability parity with the reference tree layer
(reference ``raocp/core/scenario_tree.py:21`` ``ScenarioTree`` and
``:243`` ``MarkovChainScenarioTreeFactory``), re-designed for batched
device use:

* Node data lives in flat int/float numpy arrays (ancestor, stage,
  probability, w-index) ordered stage-major, so every stage is a contiguous
  node range and children of consecutive nodes are contiguous. These arrays
  drive the gather/scatter index plans of the batched solver kernels.
* Construction is O(num_nodes) (the reference repeatedly ``np.concatenate``s,
  which is quadratic — see ``scenario_tree.py:299``).
* Visualisation uses matplotlib (the reference uses ``turtle``).

The tree itself is host-side metadata: it is built once, is tiny compared to
the solve, and only its derived index plans are shipped to the device.
"""

from typing import Optional

import numpy as np

__all__ = ["ScenarioTree", "MarkovChainScenarioTreeFactory"]


def _check_probability_vector(p) -> None:
    p = np.asarray(p, dtype=float)
    if abs(p.sum() - 1.0) >= 1e-10:
        raise ValueError(f"probabilities must total 1 (sum = {p.sum()!r})")
    if (p <= -1e-16).any():
        raise ValueError("probability vector contains negative entries")


def _check_stopping_time(num_stages: int, stopping_time: int) -> None:
    if stopping_time > num_stages:
        raise ValueError(f"stopping time ({stopping_time}) cannot exceed "
                         f"the horizon ({num_stages} stages)")


class ScenarioTree:
    """A scenario tree as flat arrays (stage-major node ordering).

    Parity: reference ``scenario_tree.py:21``. Accessor API matches the
    reference; extra properties expose the index plans used by the batched
    device kernels (children ranges, padded child tables, stage offsets).

    :param stages: ``stages[i]`` = stage of node ``i``
    :param ancestors: ``ancestors[i]`` = ancestor (parent) of node ``i``
        (``-1`` for the root)
    :param probability: ``probability[i]`` = probability of visiting node ``i``
    :param w_values: ``w_values[i]`` = disturbance (Markov mode) index at node
        ``i`` (if any)

    Note: avoid calling this constructor directly; use a factory.
    """

    def __init__(self, stages, ancestors, probability, w_values=None,
                 is_markovian: bool = False):
        self.__stages = np.asarray(stages, dtype=np.int64)
        self.__ancestors = np.asarray(ancestors, dtype=np.int64)
        self.__probability = np.asarray(probability, dtype=np.float64)
        self.__w_idx = None if w_values is None else np.asarray(w_values,
                                                                dtype=np.int64)
        self.__is_markovian = is_markovian
        self.__data = np.empty(shape=(self.num_nodes,), dtype=object)
        self._build_index_plans()

    # -- index plans ------------------------------------------------------

    def _build_index_plans(self) -> None:
        """Derive the contiguous-children / stage-offset index plans.

        Requires stage-major ordering: node indices sorted by stage, and the
        children of node ``i`` forming the contiguous block
        ``[child_first[i], child_first[i] + child_count[i])``.
        """
        n = self.num_nodes
        if n == 0:
            raise ValueError("tree must have at least one node")
        if (np.diff(self.__stages) < 0).any():
            raise ValueError("nodes must be ordered stage-major")
        if self.__ancestors[0] != -1:
            raise ValueError("root node must have ancestor -1")
        n_nonleaf = int(np.sum(self.__stages < self.num_stages - 1))
        self.__num_nonleaf = n_nonleaf

        # children of i are all j with ancestors[j] == i; ancestors must be
        # non-decreasing for contiguity
        anc = self.__ancestors
        if n > 2 and (np.diff(anc[1:]) < 0).any():
            raise ValueError("ancestor array must be non-decreasing "
                             "(children of consecutive nodes contiguous)")
        child_count = np.zeros(n_nonleaf, dtype=np.int64)
        np.add.at(child_count, anc[1:], 1)
        if (child_count == 0).any():
            raise ValueError("every nonleaf node must have at least one child")
        child_first = np.zeros(n_nonleaf, dtype=np.int64)
        child_first[:] = 1 + np.concatenate(([0], np.cumsum(child_count)[:-1]))
        self.__child_first = child_first
        self.__child_count = child_count

        # rank of node j among its siblings (root gets rank 0)
        rank = np.zeros(n, dtype=np.int64)
        rank[1:] = np.arange(1, n) - child_first[anc[1:]]
        self.__child_rank = rank

        # stage offsets: nodes at stage k are [stage_start[k], stage_start[k+1])
        counts = np.bincount(self.__stages, minlength=self.num_stages)
        self.__stage_start = np.concatenate(([0], np.cumsum(counts)))

        d_max = int(child_count.max()) if n_nonleaf else 0
        self.__max_branching = d_max

        # padded child table: children_padded[i, c] = child index (0-padded)
        pad_idx = np.zeros((n_nonleaf, d_max), dtype=np.int64)
        pad_mask = np.zeros((n_nonleaf, d_max), dtype=bool)
        cols = np.arange(d_max)[None, :]
        pad_mask[:] = cols < child_count[:, None]
        clipped = np.minimum(child_first[:, None] + cols,
                             n - 1)
        pad_idx[:] = np.where(pad_mask, clipped, 0)
        self.__children_padded = pad_idx
        self.__children_mask = pad_mask

    # -- reference-parity accessors ---------------------------------------

    @property
    def is_markovian(self) -> bool:
        return self.__is_markovian

    @property
    def num_nonleaf_nodes(self) -> int:
        """Number of nodes that have children (parity: scenario_tree.py:77)."""
        return self.__num_nonleaf

    @property
    def num_leaf_nodes(self) -> int:
        return self.num_nodes - self.__num_nonleaf

    @property
    def num_nodes(self) -> int:
        return len(self.__ancestors)

    @property
    def num_stages(self) -> int:
        """Number of stages including stage zero (parity: scenario_tree.py:91)."""
        return int(self.__stages[-1]) + 1

    def ancestor_of(self, node_idx):
        return self.__ancestors[node_idx]

    def children_of(self, node_idx):
        """Array of children of a nonleaf node (raises IndexError on a leaf,
        like reference ``children_of``)."""
        first = self.__child_first[node_idx]
        return np.arange(first, first + self.__child_count[node_idx])

    def stage_of(self, node_idx):
        if np.any(np.asarray(node_idx) < 0):
            raise ValueError("node_idx cannot be <0")
        return self.__stages[node_idx]

    def value_at_node(self, node_idx):
        """Disturbance (w) index at the given node(s), if any."""
        if self.__w_idx is None:
            return None
        return self.__w_idx[node_idx]

    def nodes_at_stage(self, stage_idx):
        return np.arange(self.__stage_start[stage_idx],
                         self.__stage_start[stage_idx + 1])

    def probability_of_node(self, node_idx):
        return self.__probability[node_idx]

    def siblings_of_node(self, node_idx):
        if node_idx == 0:
            return [0]
        return self.children_of(self.ancestor_of(node_idx))

    def conditional_probabilities_of_children(self, node_idx):
        children = self.children_of(node_idx)
        return self.__probability[children] / self.__probability[node_idx]

    def get_data_at_node(self, node_idx):
        return self.__data[node_idx]

    def set_data_at_node(self, node_idx, data_dict: dict) -> None:
        self.__data[node_idx] = data_dict

    # -- index-plan accessors ------------------------------------------

    @property
    def ancestors(self) -> np.ndarray:
        """``ancestors[i]`` = parent of node ``i`` (root: -1)."""
        return self.__ancestors

    @property
    def stages(self) -> np.ndarray:
        return self.__stages

    @property
    def probabilities(self) -> np.ndarray:
        return self.__probability

    @property
    def w_values(self) -> Optional[np.ndarray]:
        return self.__w_idx

    @property
    def max_branching(self) -> int:
        """Maximum number of children over all nonleaf nodes (pad width)."""
        return self.__max_branching

    @property
    def child_first(self) -> np.ndarray:
        """First child of each nonleaf node (children are contiguous)."""
        return self.__child_first

    @property
    def child_count(self) -> np.ndarray:
        return self.__child_count

    @property
    def child_rank(self) -> np.ndarray:
        """Rank of each node among its siblings (root: 0)."""
        return self.__child_rank

    @property
    def children_padded(self) -> np.ndarray:
        """``[num_nonleaf, max_branching]`` child-index table, 0-padded."""
        return self.__children_padded

    @property
    def children_mask(self) -> np.ndarray:
        """Boolean validity mask matching :attr:`children_padded`."""
        return self.__children_mask

    @property
    def stage_start(self) -> np.ndarray:
        """``stage_start[k]`` = first node of stage ``k``; length num_stages+1."""
        return self.__stage_start

    @property
    def stage_child(self):
        """Per nonleaf stage: the uniform child count, or None where
        branching is ragged within the stage. THE single source of the
        stage-uniformity structure: ``core.stacked.build_stacked`` bakes
        it into the StackedProblem statics and
        ``parallel.subtree.choose_frontier`` decides partition
        eligibility from it pre-build — both must agree by construction."""
        ss = self.stage_start
        cc = self.child_count
        out = []
        for k in range(self.num_stages - 1):
            counts = cc[ss[k]:ss[k + 1]]
            out.append(int(counts[0]) if len(counts)
                       and (counts == counts[0]).all() else None)
        return tuple(out)

    # -- display -----------------------------------------------------------

    def __str__(self) -> str:
        return (f"Scenario Tree\n+ Nodes: {self.num_nodes}\n"
                f"+ Stages: {self.num_stages}\n"
                f"+ Scenarios: {len(self.nodes_at_stage(self.num_stages - 1))}")

    def __repr__(self) -> str:
        return (f"Scenario tree with {self.num_nodes} nodes, "
                f"{self.num_stages} stages and "
                f"{len(self.nodes_at_stage(self.num_stages - 1))} scenarios")

    def bulls_eye_plot(self, dot_size: float = 5, radius: float = 300,
                       filename: Optional[str] = None, show: bool = True):
        """Bull's-eye plot of the scenario tree (matplotlib; the reference
        draws the same figure with turtle — ``scenario_tree.py:217``)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        ax.set_aspect("equal")
        ax.axis("off")
        num_stages = self.num_stages
        leaf_nodes = self.nodes_at_stage(num_stages - 1)
        arcs = np.zeros(self.num_nodes)
        arcs[leaf_nodes] = np.arange(len(leaf_nodes)) * (360.0 / len(leaf_nodes))
        radii = np.linspace(0.0, radius, num_stages)

        def xy(rad, arc_deg):
            return (rad * np.cos(np.deg2rad(arc_deg)),
                    rad * np.sin(np.deg2rad(arc_deg)))

        # rings
        for rad in radii[1:]:
            circ = plt.Circle((0, 0), rad, fill=False, color="0.8", lw=0.8)
            ax.add_patch(circ)
        # walk stages from leaves to root, averaging child arcs
        for stage in range(num_stages - 2, -1, -1):
            for n in self.nodes_at_stage(stage):
                arcs[n] = np.mean(arcs[self.children_of(n)])
        # edges + dots
        for n in range(self.num_nodes):
            px, py = xy(radii[self.stage_of(n)], arcs[n])
            if n > 0:
                a = self.ancestor_of(n)
                ax_, ay_ = xy(radii[self.stage_of(a)], arcs[a])
                ax.plot([ax_, px], [ay_, py], color="0.6", lw=0.8, zorder=1)
            ax.scatter([px], [py], s=dot_size ** 2, color="k", zorder=2)
        ax.set_xlim(-radius * 1.05, radius * 1.05)
        ax.set_ylim(-radius * 1.05, radius * 1.05)
        if filename is not None:
            fig.savefig(filename)
        if show:
            plt.show()
        return fig


class MarkovChainScenarioTreeFactory:
    """Build a scenario tree from a (stopped) Markov chain.

    Parity: reference ``scenario_tree.py:243``. Semantics are identical —
    stage-1 nodes are the nonzero entries of the initial distribution, each
    node at stages ``1..stopping_time-1`` branches per nonzero entry of its
    transition row, and after the stopping time every node has exactly one
    child (probabilities copied) — but construction is O(num_nodes) using
    preallocation-friendly list appends instead of repeated concatenation.

    :param transition_prob: Markov transition matrix P (rows sum to 1)
    :param initial_distribution: initial distribution of w
    :param num_stages: horizon N of the scenario tree
    :param stopping_time: stopping time tau <= N [default: N]
    """

    def __init__(self, transition_prob, initial_distribution, num_stages: int,
                 stopping_time: Optional[int] = None):
        transition_prob = np.asarray(transition_prob, dtype=np.float64)
        initial_distribution = np.asarray(initial_distribution,
                                          dtype=np.float64)
        if stopping_time is None:
            stopping_time = num_stages
        else:
            _check_stopping_time(num_stages, stopping_time)
        for row in transition_prob:
            _check_probability_vector(row)
        _check_probability_vector(initial_distribution)
        self.__p = transition_prob
        self.__v = initial_distribution
        self.__num_stages = int(num_stages)
        self.__stopping_time = int(stopping_time)

    def create(self) -> ScenarioTree:
        p, v = self.__p, self.__v
        covers = [np.flatnonzero(p[w]) for w in range(p.shape[0])]

        ancestors = [-1]
        values = [-1]
        stages = [0]
        probs = [1.0]

        # stage 1: nonzero entries of the initial distribution
        init_support = np.flatnonzero(v)
        frontier = []  # (node_id, w) of the current last stage
        for w in init_support:
            node_id = len(ancestors)
            ancestors.append(0)
            values.append(int(w))
            stages.append(1)
            probs.append(float(v[w]))
            frontier.append((node_id, int(w)))

        # stages 2..stopping_time: branch per nonzero transition entry
        for stage in range(2, self.__stopping_time + 1):
            new_frontier = []
            for (parent, w) in frontier:
                for w_next in covers[w]:
                    node_id = len(ancestors)
                    ancestors.append(parent)
                    values.append(int(w_next))
                    stages.append(stage)
                    probs.append(probs[parent] * float(p[w, w_next]))
                    new_frontier.append((node_id, int(w_next)))
            frontier = new_frontier

        # stages stopping_time+1..N: single-child chain, probability copied
        for stage in range(self.__stopping_time + 1, self.__num_stages + 1):
            new_frontier = []
            for (parent, w) in frontier:
                node_id = len(ancestors)
                ancestors.append(parent)
                values.append(w)
                stages.append(stage)
                probs.append(probs[parent])
                new_frontier.append((node_id, w))
            frontier = new_frontier

        return ScenarioTree(np.asarray(stages), np.asarray(ancestors),
                            np.asarray(probs), np.asarray(values),
                            is_markovian=True)
