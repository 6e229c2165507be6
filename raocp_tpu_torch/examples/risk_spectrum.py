"""Compare risk measures on the demo problem: expectation -> AVaR ->
total-variation robust -> worst case.

Solves the reference demo configuration to 1e-4 under a spectrum of risk
measures and prints the optimal nested cost (``result.objective``) beside
an independent host-side evaluation of the returned trajectory
(:func:`raocp_tpu_torch.utils.evaluate.risk_value`). More risk aversion =>
higher optimal cost; AVaR(1) = TV(0) = MSD(0) = expectation.

    python -m raocp_tpu_torch.examples.risk_spectrum [--device cpu]
"""

import argparse

import torch

import raocp_tpu_torch as r
from raocp_tpu_torch.models import demo_problem
from raocp_tpu_torch.utils.evaluate import risk_value

# (label, risk measure), from the least risk-averse to the most
RISKS = [
    ("expectation  AVaR(1.0)", lambda: r.AVaR(1.0)),
    ("             TV(0.0)", lambda: r.TotalVariation(0.0)),
    ("             MSD(0.0)", lambda: r.MeanUpperSemideviation(0.0)),
    ("             L2Ball(0.0)", lambda: r.L2Ball(0.0)),
    ("mild         MSD(0.5)", lambda: r.MeanUpperSemideviation(0.5)),
    ("             L2Ball(0.3)", lambda: r.L2Ball(0.3)),
    ("             TV(0.3)", lambda: r.TotalVariation(0.3)),
    ("             W1(0.2)", lambda: r.Wasserstein(0.2)),
    ("             AVaR(0.95)", lambda: r.AVaR(0.95)),
    ("strong       TV(1.0)", lambda: r.TotalVariation(1.0)),
    ("             AVaR(0.5)", lambda: r.AVaR(0.5)),
    ("worst case   AVaR(0.0)", lambda: r.AVaR(0.0)),
    ("             TV(2.0)", lambda: r.TotalVariation(2.0)),
    ("             L2Ball(1.5)", lambda: r.L2Ball(1.5)),
]


def main(device="cuda", dtype=torch.float64, risks=RISKS) -> list:
    """Solve the demo under each of ``risks`` on ``device`` and print a
    row each; returns the rows (label, iterations, objective, the
    recursion's value, converged)."""
    print(f"{'risk measure':28s} {'iters':>6s} {'objective':>12s} "
          f"{'recursion':>12s}")
    rows = []
    for label, risk in risks:
        problem, x0 = demo_problem(risk=risk())
        solver = r.Solver(problem, dtype=dtype, device=device)
        res = solver.solve(x0, max_iters=20000, tol=1e-4)
        v0 = risk_value(problem, res.primal.x, res.primal.u)
        flag = "" if res.converged else "  (max_iters!)"
        print(f"{label:28s} {res.num_iters:6d} {res.objective:12.6f} "
              f"{v0:12.6f}{flag}")
        rows.append(dict(label=label.strip(), iterations=res.num_iters,
                         objective=res.objective, recursion=v0,
                         converged=res.converged))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
