"""Example RAOCP problem families.

``demo_problem`` reproduces the reference's canonical end-to-end experiment
(reference ``main.py:11-80``: 3-mode Markov chain, 3 states/2 inputs,
quadratic costs, box constraints, AVaR(0.95)) — it is the iteration-count
parity benchmark (937 CP iterations to 1e-3). The other families implement
the scaling configs from BASELINE.json (binary LQR, mass-spring chain,
random networks of arbitrary size).
"""

import numpy as np

from raocp_tpu_torch.core.constraints.sets import Ball, Rectangle
from raocp_tpu_torch.core.elements import (AVaR, Dynamics, Leaf, Nonleaf,
                                           Quadratic)
from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.core.tree import MarkovChainScenarioTreeFactory

__all__ = ["demo_problem", "lqr_binary_problem", "mass_spring_problem",
           "random_network_problem", "soc_network_problem",
           "demo_mpc_controller", "network_mpc_controller"]


def demo_problem(num_stages: int = 4, stopping_time: int = 3,
                 initial_distribution=None, risk=None):
    """The reference main.py configuration (32-node tree at defaults).

    Returns (problem, initial_state). ``initial_distribution`` overrides the
    root mode distribution (used by the closed-loop MPC factory); ``risk``
    overrides the AVaR(0.95) risk measure (e.g. ``TotalVariation(0.5)``).
    """
    p = np.array([[0.1, 0.8, 0.1],
                  [0.4, 0.6, 0.0],
                  [0.0, 0.3, 0.7]])
    v = (np.array([0.1, 0.6, 0.3]) if initial_distribution is None
         else np.asarray(initial_distribution, dtype=float))
    tree = MarkovChainScenarioTreeFactory(p, v, num_stages,
                                          stopping_time).create()

    nl, lf = Nonleaf(), Leaf()
    num_states, num_inputs = 3, 2
    factor = 0.1
    Aw = factor * np.array([[1, 2, 1], [1, 1, 2], [2, 1, 1]], dtype=float)
    Bw = factor * np.array([[1, 0], [1, 0], [0, 2]], dtype=float)
    dynamics = [Dynamics(0.5 * Aw, -0.5 * Bw),
                Dynamics(Aw, Bw),
                Dynamics(-0.5 * Aw, 0.5 * Bw)]

    Q = 0.2 * factor * np.eye(num_states)
    R = 0.2 * factor * np.eye(num_inputs)
    Pf = 0.1 * factor * np.eye(num_states)
    nonleaf_costs = [Quadratic(nl, Q, R) for _ in range(3)]
    leaf_cost = Quadratic(lf, Pf)

    x_lim, u_lim = 7.0, 0.1
    nl_min = np.concatenate((-x_lim * np.ones(num_states),
                             -u_lim * np.ones(num_inputs)))
    nl_max = -nl_min
    l_min = -x_lim * np.ones(num_states)
    l_max = -l_min

    problem = (RAOCP(scenario_tree=tree)
               .with_markovian_dynamics(dynamics)
               .with_markovian_nonleaf_costs(nonleaf_costs)
               .with_all_leaf_costs(leaf_cost)
               .with_all_risks(AVaR(0.95) if risk is None else risk)
               .with_all_nonleaf_constraints(Rectangle(nl, nl_min, nl_max))
               .with_all_leaf_constraints(Rectangle(lf, l_min, l_max)))
    initial_state = np.array([5.0, -6.0, -1.0])
    return problem, initial_state


def lqr_binary_problem(num_stages: int = 3, alpha: float = 0.9):
    """2-state/1-input LQR-style RAOCP on a binary tree (BASELINE config 1)."""
    p = np.array([[0.6, 0.4], [0.3, 0.7]])
    v = np.array([0.5, 0.5])
    tree = MarkovChainScenarioTreeFactory(p, v, num_stages).create()
    nl, lf = Nonleaf(), Leaf()
    A0 = np.array([[1.0, 0.1], [0.0, 1.0]])
    A1 = np.array([[1.0, 0.2], [0.0, 0.9]])
    B = np.array([[0.0], [0.1]])
    dynamics = [Dynamics(A0, B), Dynamics(A1, B)]
    costs = [Quadratic(nl, np.eye(2), 0.1 * np.eye(1)) for _ in range(2)]
    problem = (RAOCP(scenario_tree=tree)
               .with_markovian_dynamics(dynamics)
               .with_markovian_nonleaf_costs(costs)
               .with_all_leaf_costs(Quadratic(lf, np.eye(2)))
               .with_all_risks(AVaR(alpha))
               .with_all_nonleaf_constraints(
                   Rectangle(nl, -np.ones(3), np.ones(3)))
               .with_all_leaf_constraints(
                   Rectangle(lf, -np.ones(2), np.ones(2))))
    return problem, np.array([0.4, -0.3])


def _mass_spring_matrices(num_masses: int, dt: float = 0.05,
                          k_spring: float = 2.0, damping: float = 0.1):
    """Discretised chain of masses coupled by springs; n = 2*num_masses."""
    n = 2 * num_masses
    A_cont = np.zeros((n, n))
    lap = (np.diag(2.0 * np.ones(num_masses))
           - np.diag(np.ones(num_masses - 1), 1)
           - np.diag(np.ones(num_masses - 1), -1))
    A_cont[:num_masses, num_masses:] = np.eye(num_masses)
    A_cont[num_masses:, :num_masses] = -k_spring * lap
    A_cont[num_masses:, num_masses:] = -damping * np.eye(num_masses)
    A = np.eye(n) + dt * A_cont
    B = np.zeros((n, num_masses))
    B[num_masses:] = dt * np.eye(num_masses)
    return A, B


def mass_spring_problem(num_masses: int = 5, num_stages: int = 6,
                        stopping_time: int = None, alpha: float = 0.95):
    """Mass-spring chain (10 states at default), branching-2 tree
    (BASELINE config 2)."""
    p = np.array([[0.7, 0.3], [0.4, 0.6]])
    v = np.array([0.5, 0.5])
    tree = MarkovChainScenarioTreeFactory(p, v, num_stages,
                                          stopping_time).create()
    nl, lf = Nonleaf(), Leaf()
    A, B = _mass_spring_matrices(num_masses)
    # two modes: nominal and weakened springs
    A2, B2 = _mass_spring_matrices(num_masses, k_spring=1.5)
    dynamics = [Dynamics(A, B), Dynamics(A2, B2)]
    n, m = A.shape[0], B.shape[1]
    costs = [Quadratic(nl, np.eye(n), 0.1 * np.eye(m)) for _ in range(2)]
    u_lim = 0.5
    nl_min = np.concatenate((np.full(n, -np.inf), -u_lim * np.ones(m)))
    nl_max = np.concatenate((np.full(n, np.inf), u_lim * np.ones(m)))
    problem = (RAOCP(scenario_tree=tree)
               .with_markovian_dynamics(dynamics)
               .with_markovian_nonleaf_costs(costs)
               .with_all_leaf_costs(Quadratic(lf, np.eye(n)))
               .with_all_risks(AVaR(alpha))
               .with_all_nonleaf_constraints(Rectangle(nl, nl_min, nl_max)))
    rng = np.random.default_rng(0)
    return problem, 0.2 * rng.standard_normal(n)


def random_network_problem(num_states: int = 20, num_inputs: int = 8,
                           num_modes: int = 3, num_stages: int = 7,
                           stopping_time: int = 3, alpha: float = 0.95,
                           seed: int = 0, spectral_radius: float = 0.9,
                           initial_distribution=None,
                           constraint: str = "box"):
    """Random stable networked system; tree size controlled by
    (num_modes, num_stages, stopping_time) — BASELINE configs 3-5.

    ``initial_distribution`` overrides the sampled root mode distribution
    while keeping every other draw (dynamics, costs) identical for the same
    seed — calls with different distributions describe the same plant.
    ``constraint`` is "box" (rectangles, default) or "ball" (Euclidean-norm
    state-input balls — the SOC constraints of BASELINE config 3)."""
    rng = np.random.default_rng(seed)
    p = rng.random((num_modes, num_modes)) + 0.1
    p /= p.sum(axis=1, keepdims=True)
    v = rng.random(num_modes) + 0.1
    v /= v.sum()
    if initial_distribution is not None:
        v = np.asarray(initial_distribution, dtype=float)
    tree = MarkovChainScenarioTreeFactory(p, v, num_stages,
                                          stopping_time).create()
    nl, lf = Nonleaf(), Leaf()
    dynamics = []
    for _ in range(num_modes):
        A = rng.standard_normal((num_states, num_states))
        A *= spectral_radius / max(abs(np.linalg.eigvals(A)))
        B = rng.standard_normal((num_states, num_inputs)) / np.sqrt(num_states)
        dynamics.append(Dynamics(A, B))
    costs = [Quadratic(nl, np.eye(num_states), 0.1 * np.eye(num_inputs))
             for _ in range(num_modes)]
    if constraint == "ball":
        nl_con = Ball(nl, radius=10.0)
        lf_con = Ball(lf, radius=10.0)
    elif constraint == "box":
        nl_min = np.concatenate((np.full(num_states, -10.0),
                                 np.full(num_inputs, -1.0)))
        nl_con = Rectangle(nl, nl_min, -nl_min)
        lf_con = Rectangle(lf, np.full(num_states, -10.0),
                           np.full(num_states, 10.0))
    else:
        raise ValueError(f"unknown constraint kind '{constraint}'")
    problem = (RAOCP(scenario_tree=tree)
               .with_markovian_dynamics(dynamics)
               .with_markovian_nonleaf_costs(costs)
               .with_all_leaf_costs(Quadratic(lf, np.eye(num_states)))
               .with_all_risks(AVaR(alpha))
               .with_all_nonleaf_constraints(nl_con)
               .with_all_leaf_constraints(lf_con))
    return problem, 0.5 * rng.standard_normal(num_states)


def soc_network_problem(num_states: int = 20, num_inputs: int = 8,
                        num_modes: int = 3, num_stages: int = 7,
                        stopping_time: int = 3, alpha: float = 0.95,
                        seed: int = 0):
    """BASELINE config 3: 20-state system, branching-3 tree, horizon 7
    (148 nodes at these defaults: three branching stages to the stopping
    time, then chains), Euclidean-ball (SOC) state-input constraints +
    AVaR."""
    return random_network_problem(
        num_states=num_states, num_inputs=num_inputs, num_modes=num_modes,
        num_stages=num_stages, stopping_time=stopping_time, alpha=alpha,
        seed=seed, constraint="ball")

def demo_mpc_controller(dtype=None, num_stages: int = 4,
                        stopping_time: int = 3, mesh=None, device="cuda"):
    """Closed-loop risk-averse MPC on the reference demo plant
    (BASELINE config 5 shape at small scale).

    Returns (controller, initial_state); run with
    ``controller.run(x0, num_steps)``."""
    from raocp_tpu_torch.mpc import RiskAverseMPC

    p = np.array([[0.1, 0.8, 0.1],
                  [0.4, 0.6, 0.0],
                  [0.0, 0.3, 0.7]])

    def factory(v):
        problem, _ = demo_problem(num_stages=num_stages,
                                  stopping_time=stopping_time,
                                  initial_distribution=v)
        return problem

    return (RiskAverseMPC(factory, p, dtype=dtype, mesh=mesh, device=device),
            np.array([5.0, -6.0, -1.0]))


def network_mpc_controller(num_states: int = 20, num_inputs: int = 8,
                           num_modes: int = 3, num_stages: int = 7,
                           stopping_time: int = 3, alpha: float = 0.95,
                           seed: int = 0, dtype=None,
                           offline: str = "host", mesh=None, device="cuda"):
    """Closed-loop MPC on the random-network plant at any scale
    (full BASELINE config 5 with num_states=100, num_inputs=40,
    num_stages=10, stopping_time=10: 88,573 nodes). Returns
    (controller, initial_state)."""
    from raocp_tpu_torch.mpc import RiskAverseMPC

    rng = np.random.default_rng(seed)
    p = rng.random((num_modes, num_modes)) + 0.1
    p /= p.sum(axis=1, keepdims=True)

    def factory(v):
        problem, _ = random_network_problem(
            num_states=num_states, num_inputs=num_inputs,
            num_modes=num_modes, num_stages=num_stages,
            stopping_time=stopping_time, alpha=alpha, seed=seed,
            initial_distribution=v)
        return problem

    _, x0 = random_network_problem(
        num_states=num_states, num_inputs=num_inputs, num_modes=num_modes,
        num_stages=2, stopping_time=1, seed=seed)
    return (RiskAverseMPC(factory, p, dtype=dtype, offline=offline,
                          mesh=mesh, device=device), x0)

