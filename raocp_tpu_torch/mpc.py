"""Closed-loop risk-averse MPC on scenario trees (counterpart of
:mod:`raocp_tpu.mpc`; BASELINE config 5).

At every time step the controller observes the plant state and Markov mode,
solves the RAOCP rooted at that mode (warm-started from the previous
solution), applies the root control, and the plant evolves one step under a
freshly sampled mode transition. One :class:`~raocp_tpu_torch.Solver` is
built per distinct root mode, on the controller's ``device``, and cached.
"""

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np

from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.solver import Solver, SolverResult

__all__ = ["ClosedLoopResult", "RiskAverseMPC"]


@dataclasses.dataclass
class ClosedLoopResult:
    """Trajectory and per-step solver statistics of a closed-loop run."""

    states: np.ndarray        # [T+1, n] realized plant states
    inputs: np.ndarray        # [T, m] applied controls
    modes: np.ndarray         # [T+1] realized Markov modes
    stage_costs: np.ndarray   # [T] realized x'Qx + u'Ru per step
    iterations: np.ndarray    # [T] CP iterations per solve
    solve_times: np.ndarray   # [T] wall-clock seconds per solve
    statuses: np.ndarray      # [T] solver status (0 = converged)

    @property
    def total_cost(self) -> float:
        return float(np.sum(self.stage_costs))

    @property
    def num_steps(self) -> int:
        return len(self.inputs)

    @property
    def converged(self) -> bool:
        return bool(np.all(self.statuses == 0))


class RiskAverseMPC:
    """Receding-horizon controller wrapping the Chambolle-Pock solver.

    :param problem_factory: callable mapping a stage-1 mode distribution
        ``v`` (length = number of Markov modes; the controller passes the
        transition row of the observed mode) to an assembled
        :class:`~raocp_tpu_torch.core.spec.RAOCP`. Called once per
        distinct root mode; the resulting solvers are cached.
    :param transition_matrix: the plant's Markov transition matrix ``P``
        (rows sum to 1); row ``w`` drives the mode sampled at each step.
    :param plant_dynamics: optional per-mode ``(A, B)`` pairs for the true
        plant. Defaults to the mode dynamics of the factory's problems
        (certainty about the model — the usual closed-loop experiment).
    :param dtype: forwarded to :class:`~raocp_tpu_torch.solver.Solver`.
    :param offline: forwarded to :class:`~raocp_tpu_torch.solver.Solver`
        (a fully tabled tree takes the host stage tables either way).
    :param mesh: optional 1-D ``DeviceMesh``
        (:func:`raocp_tpu_torch.parallel.make_mesh`) forwarded to every
        cached per-mode :class:`~raocp_tpu_torch.Solver`: each per-step
        solve then runs partitioned over the ranks (BASELINE config 5's
        "partitioned across 2+ hosts"; the subtree layout where the tree
        admits a frontier, the flat one otherwise), every rank running the
        same closed loop and applying the same controls.
    :param device: the device of every cached per-mode solver (on a mesh,
        the mesh's).
    """

    def __init__(self, problem_factory: Callable[[np.ndarray], RAOCP],
                 transition_matrix, plant_dynamics: Optional[Sequence] = None,
                 dtype=None, offline: str = "host", mesh=None,
                 device="cuda"):
        self.__mesh = mesh
        self.__factory = problem_factory
        self.__p = np.asarray(transition_matrix, dtype=np.float64)
        if self.__p.ndim != 2 or self.__p.shape[0] != self.__p.shape[1]:
            raise ValueError("transition matrix must be square")
        self.__num_modes = self.__p.shape[0]
        self.__plant = plant_dynamics
        self.__dtype = dtype
        self.__offline = offline
        self.__device = device
        self.__solvers = {}          # root mode -> (Solver, problem)

    @property
    def num_modes(self) -> int:
        return self.__num_modes

    def solver_for_mode(self, mode: int):
        """The (cached) solver + problem rooted at the given mode.

        The scenario tree's stage-1 nodes are drawn from the factory's
        initial distribution, so conditioning on the observed mode ``w``
        means passing the transition row ``P[w]`` — the distribution of the
        NEXT mode — as that initial distribution."""
        if mode not in self.__solvers:
            problem = self.__factory(self.__p[mode].copy())
            self.__solvers[mode] = (Solver(problem, dtype=self.__dtype,
                                           offline=self.__offline,
                                           mesh=self.__mesh,
                                           device=self.__device),
                                    problem)
        return self.__solvers[mode]

    def _plant_step(self, problem: RAOCP, x, u, w_next: int):
        if self.__plant is not None:
            dyn = self.__plant[w_next]
            A, B = dyn.state_dynamics, dyn.control_dynamics
        else:
            # mode dynamics live on the root's child with that w value
            child = self._child_with_mode(problem, w_next)
            A = problem.state_dynamics_at_node(child)
            B = problem.control_dynamics_at_node(child)
        return A @ x + B @ u

    @staticmethod
    def _child_with_mode(problem: RAOCP, w_next: int) -> int:
        tree = problem.tree
        children = tree.children_of(0)
        values = tree.value_at_node(children)
        match = children[np.asarray(values) == w_next]
        if len(match) == 0:
            raise RuntimeError(
                f"sampled mode {w_next} is not a child of the root — "
                "transition matrix inconsistent with the factory's tree")
        return int(match[0])

    def _stage_cost(self, problem: RAOCP, x, u, w_next: int) -> float:
        # child-j cost weights apply to the parent's (x, u) — reference
        # operators.py:32-39 semantics
        child = self._child_with_mode(problem, w_next)
        cost = problem.nonleaf_cost_at_node(child)
        val = float(x @ cost.state_weights @ x)
        if cost.control_weights is not None:
            cw = cost.control_weights
            val += float(u @ cw @ u) if np.ndim(cw) == 2 else float(cw * u @ u)
        return val

    def run(self, initial_state, num_steps: int,
            initial_mode: Optional[int] = None, seed: int = 0,
            max_iters: int = 5000, tol: float = 1e-3,
            warm_start: bool = True, check_every: int = 1,
            unroll: int = 1, relax="auto",
            step_ratio: float = 1.0,
            adaptive: bool = False,
            chunk_iters: Optional[int] = None) -> ClosedLoopResult:
        """Simulate ``num_steps`` of closed-loop risk-averse MPC.

        When ``initial_mode`` is None it is sampled uniformly over modes.
        ``check_every``, ``unroll``, ``relax``, ``step_ratio``,
        ``adaptive`` and ``chunk_iters`` are forwarded to every per-step
        :meth:`Solver.solve`. ``relax`` defaults to ``"auto"`` (rho = 1.8,
        the JAX package's long-solve default); pass ``relax=1.0`` for
        reference-parity iterations.
        """
        rng = np.random.default_rng(seed)
        x = np.asarray(initial_state, dtype=np.float64).reshape(-1)
        w = int(initial_mode) if initial_mode is not None else \
            int(rng.integers(self.__num_modes))

        states, inputs, modes = [x.copy()], [], [w]
        costs, iters, times, statuses = [], [], [], []
        prev = None                    # (primal, dual) for warm starting

        for _ in range(num_steps):
            solver, problem = self.solver_for_mode(w)
            ws = None
            if warm_start and prev is not None:
                sp = solver.stacked
                if (prev[0].x.shape == (sp.np_pad, sp.n)
                        and prev[1].e1.shape == (sp.nl_pad, sp.Y)):
                    ws = prev
            tic = time.perf_counter()
            res: SolverResult = solver.solve(
                x, max_iters=max_iters, tol=tol, warm_start=ws,
                check_every=check_every, unroll=unroll, relax=relax,
                step_ratio=step_ratio, adaptive=adaptive,
                chunk_iters=chunk_iters)
            times.append(time.perf_counter() - tic)
            u = np.asarray(res.primal.u[0], dtype=np.float64)
            if warm_start:
                prev = (res.primal, res.dual)

            w_next = int(rng.choice(self.__num_modes, p=self.__p[w]))
            costs.append(self._stage_cost(problem, x, u, w_next))
            x = np.asarray(self._plant_step(problem, x, u, w_next),
                           dtype=np.float64)

            inputs.append(u)
            states.append(x.copy())
            modes.append(w_next)
            iters.append(res.num_iters)
            statuses.append(res.status)
            w = w_next

        return ClosedLoopResult(
            states=np.asarray(states), inputs=np.asarray(inputs),
            modes=np.asarray(modes), stage_costs=np.asarray(costs),
            iterations=np.asarray(iters), solve_times=np.asarray(times),
            statuses=np.asarray(statuses))
