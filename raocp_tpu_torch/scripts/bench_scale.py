"""CP iterations per second on a 10^5-node scenario tree (counterpart of
the JAX package's ``scripts/bench_scale.py``).

    python -m raocp_tpu_torch.scripts.bench_scale [--iters 1000]
        [--repeats 3] [--unroll 5] [--device cpu]

The problem: a 50-state, 20-input network on a 3-mode chain fully branched
for 10 stages (88,573 nodes), AVaR(0.95), box constraints, float32 on the
card, ``offline="device"``. The run: the step size from the power
iteration at the solver's tolerance, then ``--iters`` CP steps at
``check_every=25`` from the zero start with tolerance 0 (so every step
runs), the best of ``--repeats`` timed runs. Prints one JSON line with the
JAX script's fields and the dtype, the device, the card's ``name,
power.limit``, K1's launches beside the ``prox_f`` calls of the timed runs
and the peak device memory after the build, the power iteration and the
steps.

:func:`run_tree` runs this script and ``bench_1e6``. It runs on the card
unless ``--device cpu`` is given, and a run that raises fails the
script.
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from raocp_tpu_torch import models
from raocp_tpu_torch import solver as solver_mod
from raocp_tpu_torch.core.stacked import _torch_dtype
from raocp_tpu_torch.scripts.bench_configs import (counted_calls,
                                                   device_fields, peak_mb,
                                                   reset_peak, sync)

__all__ = ["CHECK_EVERY", "ITERS", "TreeRun", "run_tree", "tree_kwargs",
           "tree_problem"]

ITERS = 1000          # long enough that the first steps' costs are noise
CHECK_EVERY = 25      # the production stride


def tree_kwargs(num_stages: int, num_states: int = 50,
                num_inputs: int = 20) -> dict:
    """``random_network_problem``'s arguments for the scale runs' problem:
    a ``num_states``-state network on a 3-mode chain fully branched for
    ``num_stages`` stages ((3^(stages+1) - 1) / 2 nodes: 88,573 at 10,
    797,161 at 12)."""
    return dict(num_states=num_states, num_inputs=num_inputs, num_modes=3,
                num_stages=num_stages, stopping_time=num_stages)


def tree_problem(num_stages: int, num_states: int = 50, num_inputs: int = 20):
    """(problem, x0) of :func:`tree_kwargs`."""
    return models.random_network_problem(
        **tree_kwargs(num_stages, num_states, num_inputs))


@dataclasses.dataclass
class TreeRun:
    """What :func:`run_tree` made: its row, the last run's ``_run_cp``
    output (z, eta, iterations, final residuals, history), the solver and
    the initial state."""

    row: dict
    out: tuple
    solver: solver_mod.Solver
    x0: np.ndarray


def run_tree(num_stages: int, num_states: int = 50, num_inputs: int = 20,
             iters: int = ITERS, repeats: int = 1, unroll: int = 5,
             check_every: int = CHECK_EVERY, power_rel_tol: float = 1e-12,
             tol: float = 0.0, alpha=None, dtype=torch.float32,
             device="cuda"):
    """Build :func:`tree_problem` on ``device`` (``offline="device"``), take
    the step size from ``_power_iteration`` at ``power_rel_tol`` (or use
    ``alpha``), run the CP loop (``solver._run_cp``, as the JAX scripts
    run theirs) for ``iters`` steps at tolerance ``tol`` from the zero
    start ``repeats`` times, and time each run.

    Before the timed runs one run of ``check_every`` steps pays K1's
    per-problem packing, the allocator's growth and, on a card, the
    capture of the device loop's CUDA graphs (the port compiles no kernel
    per call); the row's ``loop_*`` fields are ``solver.LOOP_COUNTS`` over
    all the runs (captures and their seconds, replays, host reads).
    Returns a :class:`TreeRun`."""
    dtype = _torch_dtype(dtype)
    sync(device)
    tic = time.perf_counter()
    problem, x0 = tree_problem(num_stages, num_states, num_inputs)
    tree_s = time.perf_counter() - tic
    reset_peak(device)
    solver = solver_mod.Solver(problem, dtype=dtype, offline="device",
                               device=device)
    sp = solver.stacked
    sync(device)
    build_s = time.perf_counter() - tic
    peak_build = peak_mb(device)
    power = dict(power_iterations=None, power_seconds=None,
                 power_rel_tol=None)
    if alpha is None:
        tic = time.perf_counter()
        lam, k = solver_mod._power_iteration(sp, rel_tol=power_rel_tol)
        power = dict(power_iterations=k,
                     power_seconds=time.perf_counter() - tic,
                     power_rel_tol=power_rel_tol)
        alpha = 0.999 / lam
    peak_power = peak_mb(device)
    x0t = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=sp.dtype,
                          device=sp.device)

    def run(steps):
        z0 = sp.zero_primal()
        z0.x[0] = x0t
        return solver_mod._run_cp(sp, z0, sp.zero_dual(), x0t, alpha, alpha,
                                  tol, steps, check_every=check_every,
                                  unroll=unroll)

    counts = dict(solver_mod.LOOP_COUNTS)
    run(check_every)
    seconds = []
    with counted_calls() as calls:
        for _ in range(repeats):
            sync(device)
            tic = time.perf_counter()
            out = run(iters)
            sync(device)
            seconds.append(time.perf_counter() - tic)
    steps, err = out[2], out[3]
    best = min(seconds)
    finite = all(bool(torch.isfinite(v).all()) for v in (*out[0], *out[1]))
    row = dict(
        metric=f"cp_iterations_per_s_{sp.num_nodes}node_{num_states}"
               "state_tree",
        value=steps / best, unit="iter/s", num_nodes=sp.num_nodes,
        n=sp.n, m=sp.m, tree_seconds=tree_s, build_seconds=build_s,
        **power, alpha=float(alpha), iters=steps, tol=tol,
        converged=bool(tol > 0 and float(err.max()) <= tol),
        seconds=best, all_seconds=seconds, ms_per_step=1e3 * best / steps,
        repeats=repeats, unroll=unroll, check_every=check_every,
        **device_fields(sp), k1_launches=calls["k1"],
        prox_f_calls=calls["prox_f"],
        **{f"loop_{k}": solver_mod.LOOP_COUNTS[k] - v
           for k, v in counts.items()},
        max_memory_allocated_mb=dict(build=peak_build, power=peak_power,
                                     steps=peak_mb(device)),
        xi=err.tolist(), finite=finite)
    return TreeRun(row, out, solver, np.asarray(x0, dtype=np.float64))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--unroll", type=int, default=5,
                    help="CP steps per trip of the loop between its "
                         "stopping tests (must divide 25). The port's "
                         "device loop runs a check period of 25 steps a "
                         "graph replay either way, so this moves only "
                         "where the cap falls; the JAX script's while-loop "
                         "unrolls its body by it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = run_tree(10, iters=args.iters, repeats=args.repeats,
                   unroll=args.unroll, device=args.device).row
    print(json.dumps(row), flush=True)
    if not row["finite"]:
        raise SystemExit("the iterates are not finite")


if __name__ == "__main__":
    main()
