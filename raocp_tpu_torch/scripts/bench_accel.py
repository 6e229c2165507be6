"""Accelerated against plain CP, time to 1e-3 on BASELINE configs 1-4
(counterpart of the JAX package's ``scripts/bench_accel.py``).

    python -m raocp_tpu_torch.scripts.bench_accel [--configs 1,2,3,4]
        [--repeats 3] [--dtype float32|float64] [--device cpu]

Each config (``offline="device"``, at most 6,000 iterations for configs 1
and 2 and 20,000 for configs 3 and 4, as the JAX script caps them) runs
the JAX script's four methods: plain CP at the production stride
(``check_every=25, unroll=25``), the same with relax 1.8, Anderson (m = 5)
and SuperMann with Broyden directions (m = 5), both checked every 25
iterations. One JSON line per (config, method): the JAX script's fields,
the T evaluations (``prox_f`` calls) of the timed solve, the dtype, the
device, the card's ``name, power.limit``, K1's launches, the peak device
memory, and the JAX package's float64 count and T evaluations on the CPU
for the same options (``jax_reference.json``) beside the port's, the
timed solve's host reads an iteration and what its loops ran (``loop``,
``accel_loop``). The
accelerators amplify rounding, so their counts are reported, not held.
Each method is timed as the best of ``--repeats`` solves after a warm-up
of 25 iterations. It runs on the card unless ``--device cpu`` is given,
and a row that raises fails the run.
"""

import argparse
import json

import torch

from raocp_tpu_torch.core.stacked import _torch_dtype, default_dtype
from raocp_tpu_torch.scripts.bench_configs import CONFIGS, keyed_rows

__all__ = ["MAX_ITERS", "RUNS", "TOL", "accel_solve", "run_accel"]

TOL = 1e-3
MAX_ITERS = {1: 6000, 2: 6000, 3: 20000, 4: 20000}
# method -> its solve options
RUNS = {
    "plain_check25_unroll25": dict(check_every=25, unroll=25, relax=1.0,
                                   adaptive=False),
    "relax1.8_check25_unroll25": dict(check_every=25, unroll=25, relax=1.8,
                                      adaptive=False),
    "anderson_m5_check25": dict(accel="anderson", accel_memory=5,
                                check_every=25),
    "supermann_m5_check25": dict(accel="supermann", accel_memory=5,
                                 check_every=25),
}


def accel_solve(k: int, run: str) -> dict:
    """The options of config ``k``'s ``run`` row, the key of its reference
    row (plain CP's equal ``bench_relax``'s relax-1.0 key where the stacking
    and the cap agree)."""
    return dict(offline="device", max_iters=MAX_ITERS[k], tol=TOL,
                **RUNS[run])


def run_accel(k: int, dtype=None, device="cuda", repeats: int = 3,
              runs=tuple(RUNS)) -> list:
    """Config ``k``'s rows, one a method of ``runs``."""
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    keys = {run: accel_solve(k, run) for run in runs}
    return [dict(run=run, **row, xi_max=max(row["xi"]),
                 t_evals=row["prox_f_calls"], relax=RUNS[run].get("relax"),
                 memory=RUNS[run].get("accel_memory"),
                 jax_t_evals=ref.get("t_evals"),
                 host_reads_per_iter=row["host_reads"] / row["iterations"])
            for run, row, ref in keyed_rows(CONFIGS[k], keys, dtype, device,
                                            repeats)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1,2,3,4")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    for k in (int(c) for c in args.configs.split(",")):
        for row in run_accel(k, dtype, args.device, args.repeats):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
