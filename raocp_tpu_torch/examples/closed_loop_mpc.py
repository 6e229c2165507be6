"""Closed-loop risk-averse MPC demo (BASELINE config 5 behaviour).

Runs the reference demo plant (3-mode Markov chain, 3 states / 2 inputs,
AVaR(0.95), box constraints) in closed loop: at every step the controller
observes the state and Markov mode, re-solves the RAOCP rooted at that mode
(warm-started from the previous solution, with the solver cached per root
mode), applies the root control, and the plant transitions under a freshly
sampled mode.

    python -m raocp_tpu_torch.examples.closed_loop_mpc [num_steps]
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from raocp_tpu_torch.models import demo_mpc_controller


def main(num_steps: int = 10, device="cuda", dtype=torch.float64) -> dict:
    """Run ``num_steps`` closed-loop steps on ``device`` and print them;
    returns the realised modes, the total cost, the iterations and
    solve seconds per step, the states and whether every solve
    converged."""
    controller, x0 = demo_mpc_controller(dtype=dtype, device=device)
    result = controller.run(x0, num_steps=num_steps, initial_mode=1, seed=0,
                            max_iters=3000, tol=1e-3)

    print(f"closed-loop run: {result.num_steps} steps, "
          f"{'all solves converged' if result.converged else 'NOT converged'}")
    print(f"realized modes: {result.modes.tolist()}")
    print(f"total realized cost: {result.total_cost:.6f}")
    print(f"CP iterations per solve: {result.iterations.tolist()}")
    print(f"solve seconds per step: "
          f"{np.round(result.solve_times, 3).tolist()}")
    print(f"state norm trajectory: "
          f"{np.round(np.linalg.norm(result.states, axis=1), 3).tolist()}")
    return dict(modes=result.modes.tolist(), total_cost=result.total_cost,
                iterations=result.iterations.tolist(),
                solve_times=result.solve_times.tolist(),
                states=result.states.tolist(), converged=result.converged)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("num_steps", type=int, nargs="?", default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.num_steps, device=args.device)
