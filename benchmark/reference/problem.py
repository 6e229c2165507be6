"""The benchmark's own problem data, in NumPy: the plant of a random-network
configuration, the scenario tree of a stopped Markov chain, and the initial
states of the traffic. Both sides of a run get these same arrays: the
system under test builds its problem from them through its public API, and
the plain reference (:mod:`benchmark.reference.cp`) builds its own.

The draws copy those of the upstream project's random-network family
(BASELINE configs 3-5: a transition matrix, an initial distribution, and
per mode a state matrix scaled to a spectral radius and an input matrix,
from one NumPy generator), so that a configuration's plant is fixed by its
``plant_seed``. Nothing here imports the system under test.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_config(name: str) -> dict:
    """``benchmark/configs/<name>.json``."""
    return load_json(ROOT / "configs" / f"{name}.json")


@dataclasses.dataclass(frozen=True)
class Plant:
    """The Markov-jump plant: transition matrix ``P`` [M, M], initial
    distribution ``v`` [M], per mode ``A`` [M, n, n], ``B`` [M, n, m], and
    the family's initial state ``x0`` [n] (the generator's next draw, N(0,
    I_n), before any scaling; the first of :func:`initial_states`)."""

    P: np.ndarray
    v: np.ndarray
    A: np.ndarray
    B: np.ndarray
    x0: np.ndarray


def _draws(config: dict, count: int):
    """The configuration's plant and the family's first ``count`` initial
    states (N(0, I_n), [count, n]), drawn in this order from one generator
    seeded with its ``plant_seed``."""
    n, m, modes = (config["num_states"], config["num_inputs"],
                   config["num_modes"])
    rng = np.random.default_rng(config["plant_seed"])
    p = rng.random((modes, modes)) + 0.1
    p /= p.sum(axis=1, keepdims=True)
    v = rng.random(modes) + 0.1
    v /= v.sum()
    A, B = [], []
    for _ in range(modes):
        a = rng.standard_normal((n, n))
        a *= config["spectral_radius"] / max(abs(np.linalg.eigvals(a)))
        A.append(a)
        B.append(rng.standard_normal((n, m)) / np.sqrt(n))
    states = rng.standard_normal((count, n))
    return Plant(P=p, v=v, A=np.stack(A), B=np.stack(B),
                 x0=states[0]), states


def plant(config: dict) -> Plant:
    """The configuration's plant, drawn from its ``plant_seed``."""
    return _draws(config, 1)[0]


def initial_states(config: dict, seed: int, count: int, scale: float):
    """``count`` distinct initial states (float64 [count, n]): ``scale``
    times the family's first ``count`` draws (the first is its own x0), a
    frozen list, each with a sign drawn from ``seed``. The problem is
    symmetric under x -> -x (odd dynamics, even costs, boxes or balls
    centred on 0), so every sign takes the same work, bit for bit: a seed
    changes the inputs and not the work."""
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], size=count)
    return scale * signs[:, None] * _draws(config, count)[1]


@dataclasses.dataclass(frozen=True)
class Tree:
    """A scenario tree in breadth-first order: node 0 the root, every stage
    contiguous, each node's children contiguous and in mode order, the
    leaves last.

    ``anc`` [N] (the root's is 0), ``mode`` [N] (the root's is -1),
    ``stage`` [N], ``prob`` [N]; ``child_first`` / ``child_count`` [NL]."""

    anc: np.ndarray
    mode: np.ndarray
    stage: np.ndarray
    prob: np.ndarray
    child_first: np.ndarray
    child_count: np.ndarray

    @property
    def num_nodes(self) -> int:
        return len(self.anc)

    @property
    def num_nonleaf(self) -> int:
        return len(self.child_first)

    @property
    def num_stages(self) -> int:
        return int(self.stage[-1])

    def cond_prob(self) -> np.ndarray:
        """[N] each node's probability given its parent (1 at the root)."""
        out = np.ones(self.num_nodes)
        out[1:] = self.prob[1:] / self.prob[self.anc[1:]]
        return out


def markov_tree(P, v, num_stages: int, stopping_time: int) -> Tree:
    """The scenario tree of the Markov chain ``P`` started from ``v``:
    stage 1 holds a node for each mode of nonzero initial probability;
    until the stopping time each node branches into every mode its row of
    ``P`` reaches; after it every node has one child of its own mode."""
    anc, mode, stage, prob = [0], [-1], [0], [1.0]
    frontier = []
    for w in np.flatnonzero(v):
        frontier.append(len(anc))
        anc.append(0), mode.append(int(w)), stage.append(1)
        prob.append(float(v[w]))
    for t in range(2, num_stages + 1):
        nxt = []
        for parent in frontier:
            w = mode[parent]
            succ = np.flatnonzero(P[w]) if t <= stopping_time else [w]
            for w2 in succ:
                nxt.append(len(anc))
                anc.append(parent), mode.append(int(w2)), stage.append(t)
                prob.append(prob[parent] * (float(P[w, w2])
                                            if t <= stopping_time else 1.0))
        frontier = nxt
    anc = np.asarray(anc)
    num_nonleaf = len(anc) - len(frontier)
    counts = np.bincount(anc[1:], minlength=num_nonleaf)[:num_nonleaf]
    first = np.zeros(num_nonleaf, dtype=np.int64)
    first[0] = 1
    first[1:] = 1 + np.cumsum(counts)[:-1]
    return Tree(anc=anc, mode=np.asarray(mode), stage=np.asarray(stage),
                prob=np.asarray(prob), child_first=first,
                child_count=counts)


def config_tree(config: dict, v=None) -> Tree:
    """The configuration's tree, rooted at the initial distribution ``v``
    (the plant's own by default)."""
    pl = plant(config)
    return markov_tree(pl.P, pl.v if v is None else v, config["num_stages"],
                       config["stopping_time"])
