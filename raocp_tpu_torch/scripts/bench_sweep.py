"""The loop-control sweep on the card (counterpart of the JAX package's
``scripts/bench_sweep.py``): iter/s of the CP loop at the headline for
each ``(check_every, unroll)`` pair, with K1 and with the torch stage path.

    python -m raocp_tpu_torch.scripts.bench_sweep

The headline (BASELINE config 4: 9,841 nodes, float32,
``offline="device"``) from the zero start at alpha = 0.999 / lambda_max
(the Solver's power iteration) and tolerance 0, so that every step runs:
``solver._run_cp`` for 200 iterations at ``(25, 1) (25, 5) (25, 25) (50,
10) (100, 20)``, first with K1, then inside ``ops.sweep.stage_path()``.
Each pair runs through the device loop (CUDA graphs of its check
periods: ``unroll`` moves only where the cap falls), and prints one JSON
line a pair: the path, the pair, the iterations, iter/s of the best of 3
timed runs,
the first run's seconds (the JAX script's "warm+compile": the port
compiles no kernel per call, so this is the graphs' capture, K1's
per-problem packing and the allocator's growth on the first pair of each
path), and the K1 launches beside the ``prox_f`` calls of the timed runs.
It needs a card.
"""

import argparse
import contextlib
import json
import math
import time

import numpy as np
import torch

from raocp_tpu_torch.ops import sweep
from raocp_tpu_torch.scripts.bench_configs import (CONFIGS, card,
                                                   counted_calls, sync)
from raocp_tpu_torch.scripts.roofline import require_card
from raocp_tpu_torch.solver import Solver, _run_cp, pin_full_precision

__all__ = ["PAIRS", "sweep_rows"]

PAIRS = ((25, 1), (25, 5), (25, 25), (50, 10), (100, 20))


def _timed(sp, z0, eta0, x0, alpha, tol, iters, check_every, unroll):
    """(iterations, final residuals, seconds) of one ``_run_cp``."""
    sync(sp.device)
    tic = time.perf_counter()
    _, _, k, err, _ = _run_cp(sp, z0, eta0, x0, alpha, alpha, tol, iters,
                              check_every=check_every, unroll=unroll)
    sync(sp.device)
    return k, err, time.perf_counter() - tic


def sweep_rows(solver: Solver, x0, iters: int = 200, repeats: int = 3,
               pairs=PAIRS) -> list:
    """One dict per path ("k1", "stage") and ``(check_every, unroll)``
    pair of ``pairs`` on ``solver``'s problem."""
    sp = solver.stacked
    device = sp.device
    alpha = 0.999 / solver.operator_norm_sq()
    tol = torch.as_tensor(0.0, dtype=sp.dtype, device=device)
    x0 = torch.as_tensor(x0, dtype=sp.dtype, device=device)
    z0 = sp.zero_primal()
    z0.x[0] = x0
    eta0 = sp.zero_dual()
    out = []
    for path, scope in (("k1", contextlib.nullcontext),
                        ("stage", sweep.stage_path)):
        for pair in pairs:
            args = (sp, z0, eta0, x0, alpha, tol, iters, *pair)
            with scope():
                first = _timed(*args)[2]
                best = math.inf
                with counted_calls() as calls:
                    for _ in range(repeats):
                        k, err, secs = _timed(*args)
                        best = min(best, secs)
            out.append(dict(
                path=path, check_every=pair[0], unroll=pair[1],
                iterations=k, iter_per_s=k / best, best_s=best,
                first_s=first, k1_launches=calls["k1"],
                prox_f_calls=calls["prox_f"],
                finite=bool(np.isfinite(err).all()), nodes=sp.num_nodes,
                dtype=str(sp.dtype), card=card(device)))
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    require_card("bench_sweep")
    pin_full_precision()
    problem, x0 = CONFIGS[4].make()
    solver = Solver(problem, dtype=torch.float32, offline="device")
    for row in sweep_rows(solver, x0):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
