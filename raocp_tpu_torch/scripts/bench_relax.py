"""Over-relaxation and adaptive step balancing on BASELINE configs 2-4
(counterpart of the JAX package's ``scripts/bench_relax.py``).

    python -m raocp_tpu_torch.scripts.bench_relax [--configs 2,3,4]
        [--repeats 3] [--dtype float32|float64] [--device cpu]

Each config is solved to 1e-3 (at most 20,000 iterations, ``check_every=25,
unroll=25``) with the JAX script's five settings: relax 1.0, 1.5 and 1.8,
adaptive, and relax 1.8 with adaptive. Config 2 stacks its tables on the
host, configs 3 and 4 with ``offline="device"``, as the JAX script does.
One JSON line per (config, setting): the JAX script's fields, the dtype,
the device, the card's ``name, power.limit``, the K1 launches and
``prox_f`` calls of the timed solve, the peak device memory, and the JAX
package's float64 count on the CPU for the same options
(``jax_reference.json``). Each setting is timed as the best of
``--repeats`` solves after a warm-up of 25 iterations. It runs on the card
unless ``--device cpu`` is given, and a row that raises fails the run.
"""

import argparse
import json

import torch

from raocp_tpu_torch.core.stacked import _torch_dtype, default_dtype
from raocp_tpu_torch.scripts.bench_configs import CONFIGS, keyed_rows

__all__ = ["MAX_ITERS", "SETTINGS", "TOL", "relax_solve", "run_relax"]

MAX_ITERS = 20000
TOL = 1e-3
# name -> (relax, adaptive)
SETTINGS = {"relax1.0": (1.0, False), "relax1.5": (1.5, False),
            "relax1.8": (1.8, False), "adaptive": (1.0, True),
            "relax1.8+adaptive": (1.8, True)}


def relax_solve(k: int, setting: str) -> dict:
    """The options of config ``k``'s ``setting`` row: the stacking
    (``offline``) and the solve's, the key of its reference row."""
    relax, adaptive = SETTINGS[setting]
    return dict(offline=CONFIGS[k].offline, max_iters=MAX_ITERS, tol=TOL,
                check_every=25, unroll=25, relax=relax, adaptive=adaptive)


def run_relax(k: int, dtype=None, device="cuda", repeats: int = 3,
              settings=tuple(SETTINGS)) -> list:
    """Config ``k``'s rows, one a setting of ``settings``."""
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    keys = {setting: relax_solve(k, setting) for setting in settings}
    return [dict(setting=setting, **row) for setting, row, _
            in keyed_rows(CONFIGS[k], keys, dtype, device, repeats)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="2,3,4")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    for k in (int(c) for c in args.configs.split(",")):
        for row in run_relax(k, dtype, args.device, args.repeats):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
