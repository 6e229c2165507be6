"""A batch of initial states in one ``solve_batch`` against as many
sequential solves (counterpart of the JAX package's
``scripts/bench_batch.py``).

    python -m raocp_tpu_torch.scripts.bench_batch [--batch 8] [--small]
        [--max-iters 4000] [--device cpu]

The problem is ``soc_network_problem()`` with its defaults (148 nodes:
three branching stages to the stopping time, then chains; not BASELINE
config 3's 3,280 nodes), or with ``--small`` a 4-state one; ``offline=
"device"``, float32 on the card (float64 on the CPU). The lanes start
from ``(0.5 + r) x0``, r from ``numpy.random.default_rng(0)``, and solve
to 1e-3 at ``check_every=25, unroll=25``. After one short solve of each
kind (K1's packing of the batched and unbatched calls), the lanes are
solved one after another and then in one batch. One JSON line: the JAX
script's fields (the sequential and batched seconds, their ratio, each
lane's count), the dtype, the device, the card's ``name, power.limit``,
the batch's K1 launches beside its ``prox_f`` calls, its peak device
memory, and the JAX package's float64 count of each lane on the CPU
(``jax_reference.json``).

A lane must end as its sequential solve does (the JAX script asks every
lane to converge, but at 4,000 iterations five of the 148-node tree's
eight stop at the cap in float64), and its count may be one check period
(25) from it. In float32 a lane rounds otherwise than its single solve
(other K1 tiles, other GEMM shapes), and where its residual lingers at
the tolerance that moves its first check below it, so there the count may
be ``F32_LANE_SLACK`` of the sequential count away. It runs on the card
unless ``--device cpu`` is given.
"""

import argparse
import json
import time

import numpy as np
import torch

from raocp_tpu_torch import models
from raocp_tpu_torch import solver as solver_mod
from raocp_tpu_torch.scripts.bench_configs import (counted_calls,
                                                   device_fields, peak_mb,
                                                   reference_row, reset_peak)

__all__ = ["F32_LANE_SLACK", "SMALL", "batch_key", "batch_lanes",
           "run_batch"]

# the --small problem (the JAX script's CI size)
SMALL = dict(num_states=4, num_inputs=2, num_modes=2, num_stages=4,
             stopping_time=2)
# one check period; and in float32 a share of the sequential count (PERF.md:
# one headline lane 625 iterations, 5.3%, from its count in every float32
# run; every float64 lane within 25)
PERIOD = 25
F32_LANE_SLACK = 0.1


def batch_lanes(x0, lanes: int = 8) -> np.ndarray:
    """The JAX script's initial states: (0.5 + r) x0, r from
    ``numpy.random.default_rng(0)``."""
    x0 = np.asarray(x0, dtype=np.float64)
    return np.stack([s * x0 for s in
                     0.5 + np.random.default_rng(0).random(lanes)])


def batch_key(small: bool, lanes: int, max_iters: int) -> tuple:
    """(config name, options) of the script's row, as
    ``jax_reference.json`` keys it."""
    name = "soc_network_small" if small else "soc_network_148node"
    return name, dict(offline="device", max_iters=max_iters, tol=1e-3,
                      check_every=25, unroll=25, lanes=lanes)


def run_batch(solver, x0s, max_iters: int, alpha=None, sequential=None,
              name=None, reference=None) -> dict:
    """``solver.solve_batch(x0s)`` to 1e-3 at ``check_every=25,
    unroll=25`` against the lanes ``sequential`` (default: all) solved one
    after another, with the step size ``alpha`` (default: the solver's).
    Returns the row; raises where a lane ends otherwise than its
    sequential solve or its count is further from it than the slack."""
    kw = dict(max_iters=max_iters, tol=1e-3, check_every=PERIOD,
              unroll=PERIOD, alpha=alpha)
    lanes = range(len(x0s)) if sequential is None else sequential
    device = solver.stacked.device
    solver.solve(x0s[0], **{**kw, "max_iters": PERIOD})       # warm up
    solver.solve_batch(x0s, **{**kw, "max_iters": PERIOD})
    tic = time.perf_counter()
    seq = [solver.solve(x0s[b], **kw) for b in lanes]
    seq_s = time.perf_counter() - tic
    reset_peak(device)
    with counted_calls() as calls:
        tic = time.perf_counter()
        bat = solver.solve_batch(x0s, **kw)
        bat_s = time.perf_counter() - tic
    f64 = solver.stacked.dtype == torch.float64
    diff = [bat[b].num_iters - r.num_iters for b, r in zip(lanes, seq)]
    slack = [PERIOD if f64 else max(PERIOD, F32_LANE_SLACK * r.num_iters)
             for r in seq]
    row = dict(
        metric=f"solve_batch_speedup_b{len(x0s)}", name=name,
        nodes=solver.stacked.num_nodes, batch=len(x0s),
        sequential_lanes=list(lanes), sequential_s=seq_s, batched_s=bat_s,
        value=seq_s / bat_s if sequential is None else None, unit="x",
        iters=[r.num_iters for r in bat],
        sequential_iters=[r.num_iters for r in seq],
        statuses=[r.status for r in bat],
        sequential_statuses=[r.status for r in seq], count_diff=diff,
        count_slack=slack, alpha=bat[0].alpha,
        batched_lane_iters_per_second=sum(r.num_iters for r in bat) / bat_s,
        sequential_lane_iters_per_second=sum(
            r.num_iters for r in seq) / seq_s,
        **device_fields(solver), k1_launches=calls["k1"],
        prox_f_calls=calls["prox_f"],
        max_memory_allocated_mb=peak_mb(device),
        jax_iterations=None if reference is None
        else reference.get("lane_iterations"))
    if [bat[b].status for b in lanes] != row["sequential_statuses"]:
        raise AssertionError(f"{name}: a lane ends otherwise than its "
                             f"sequential solve: {row}")
    if any(abs(d) > s for d, s in zip(diff, slack)):
        raise AssertionError(f"{name}: a lane's count is further from its "
                             f"sequential count than {slack}: {diff}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="the JAX script's CI-sized problem")
    ap.add_argument("--max-iters", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    problem, x0 = models.soc_network_problem(**(SMALL if args.small
                                               else {}))
    solver = solver_mod.Solver(problem, offline="device", device=args.device)
    name, key = batch_key(args.small, args.batch, args.max_iters)
    row = run_batch(solver, batch_lanes(x0, args.batch), args.max_iters,
                    name=name, reference=reference_row(name, key))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
