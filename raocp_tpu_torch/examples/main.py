"""End-to-end demo: the reference's canonical experiment (3-mode Markov
chain, 3 states / 2 inputs, quadratic costs, AVaR(0.95), box constraints)
solved to 1e-3 in 937 CP iterations in float64, then its residuals and
solution plotted to ``residuals.png`` and ``solution.png`` where matplotlib
is installed.

    python -m raocp_tpu_torch.examples.main [--device cpu]
"""

import argparse
import importlib.util

import torch

from raocp_tpu_torch import Solver
from raocp_tpu_torch.models import demo_problem


def main(device="cuda", dtype=torch.float64) -> dict:
    """Solve the demo on ``device``, print and plot the result; returns
    the status, the iterations, the final residuals and the objective."""
    problem, x0 = demo_problem()
    print(problem.tree)
    solver = Solver(problem, dtype=dtype, device=device)
    status = solver.chock(initial_state=x0, max_iters=2000, tol=1e-3)
    result = solver.result
    print("success" if status == 0 else "fail")
    print(f"iterations: {result.num_iters}")
    print(f"final residuals (xi_0, xi_1, xi_2): {result.xi}")
    print(f"solve wall-clock: {result.solve_time:.3f}s "
          f"(includes K1's per-problem packing on a first call)")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plots written")
    else:
        solver.plot_residuals(filename="residuals.png", show=False)
        solver.plot_solution(filename="solution.png", show=False)
        print("wrote residuals.png, solution.png")
    return dict(status=status, iterations=result.num_iters,
                xi=result.xi.tolist(), objective=result.objective)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
