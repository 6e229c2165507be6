"""What decides ``correct``: the answers that the timed path returned, held
by the plain reference (:mod:`benchmark.reference.cp`) in float64 against
the problems they answer.

Each answer is a final iterate (z, eta). For each the reference computes

* ``xi_ratio``: the largest residual of one CP step from the answer, over
  the tolerance. A converged answer of a sound solver reads at most about
  1 (the CP map is averaged, so a step from the last iterate moves no more
  than the last checked step did); an answer capped by its iteration
  budget reads what its progress allows; an answer altered, left where it
  started, stopped early, or computed in too low a precision reads far
  above either.
* ``dyn_gap``: how far the answer's states are from the dynamics and from
  the initial state, over max(1, |x|): rounding in the precision the
  configuration states.
* ``pad``, on a tree whose nonleaf nodes have different child counts (a
  stopped Markov tree): the largest |entry| of y and e1 in the slots after
  each node's own 2 c + 1 risk rows, which the system's layout keeps at
  0. The harness holds it to exactly 0. The other numbers judge the own
  rows alone.

In a closed loop the reference works out each step's initial state itself,
from the episode's first state, the modes the run realised and the controls
it applied (the first input of each answer), so that a wrong plant step or
control shows in the next answer's residual.
"""

import numpy as np
import torch

from benchmark.reference.cp import DUAL, PRIMAL, Reference
from benchmark.reference.problem import markov_tree, plant


def trim(arrays: dict, keys, ref: Reference, device) -> dict:
    """An answer's leaves (the solver's padded arrays or the reference's
    own) cut to the reference's rows and columns, in float64; of y and e1
    each node's own risk rows, the slots after them read as 0."""
    rows = dict(x=ref.N, u=ref.NL, y=ref.NL, tau=ref.N, s=ref.N,
                e1=ref.NL, e2=ref.NL, e3=ref.N, e4=ref.N, e5=ref.N,
                e6=ref.N, e7=ref.NL, e11=ref.LF, e12=ref.LF, e13=ref.LF,
                e14=ref.LF)
    cols = dict(x=ref.n, u=ref.m, y=ref.Y, e1=ref.Y, e3=ref.n, e4=ref.m,
                e7=ref.n + ref.m, e11=ref.n, e14=ref.n)
    out = {}
    for k in keys:
        a = torch.as_tensor(np.asarray(arrays[k]), dtype=torch.float64,
                            device=device)[:rows[k]]
        out[k] = a[:, :cols[k]] if k in cols else a
        if k in ("y", "e1") and ref.rows is not None:
            out[k] = torch.where(ref.rows, out[k], 0.0)
    return out


def padding(answer: dict, ref: Reference) -> float:
    """The largest |entry| of an answer's y and e1 in the slots after each
    node's own risk rows (``ref.rows`` False)."""
    pad = ~ref.rows.cpu().numpy()
    return max(float(np.abs(np.asarray(a, dtype=np.float64)
                            [:ref.NL, :ref.Y][pad]).max(initial=0.0))
               for a in (answer["primal"]["y"], answer["dual"]["e1"]))


def episode_states(config: dict, x0, modes, answers) -> list:
    """The initial state of each step of a closed loop: ``x0``, then
    x_{k+1} = A_w x_k + B_w u_k with w the next step's mode and u_k the
    first input of answer k."""
    pl = plant(config)
    xs = [np.asarray(x0, dtype=np.float64)]
    for w, ans in zip(modes[1:], answers[:-1]):
        u = np.asarray(ans["primal"]["u"][0], dtype=np.float64)
        xs.append(pl.A[w] @ xs[-1] + pl.B[w] @ u)
    return xs


class Judge:
    """The reference problems of one configuration (one a root mode, made
    when first needed) and the numbers of each answer."""

    def __init__(self, config: dict, tol: float, device):
        self.config, self.tol, self.device = config, tol, device
        self.plant = plant(config)
        self.refs = {}

    def reference(self, mode=None) -> Reference:
        """The problem rooted at the plant's initial distribution (``mode``
        None) or at the transition row of ``mode``."""
        if mode not in self.refs:
            v = self.plant.v if mode is None else self.plant.P[mode]
            tree = markov_tree(self.plant.P, v, self.config["num_stages"],
                               self.config["stopping_time"])
            self.refs[mode] = Reference(self.config, self.plant, tree,
                                        self.device, torch.float64)
        return self.refs[mode]

    def numbers(self, answer: dict, x0, mode=None) -> dict:
        ref = self.reference(mode)
        z = trim(answer["primal"], PRIMAL, ref, self.device)
        e = trim(answer["dual"], DUAL, ref, self.device)
        x0 = torch.as_tensor(np.asarray(x0), dtype=torch.float64,
                             device=self.device)
        out = dict(xi_ratio=max(ref.residual_at(z, e, x0)) / self.tol,
                   dyn_gap=ref.dynamics_gap(z, x0))
        if ref.rows is not None:
            out["pad"] = padding(answer, ref)
        return out
