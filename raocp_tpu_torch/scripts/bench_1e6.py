"""The largest tree the JAX package runs: CP on 797,161 nodes
(counterpart of the JAX package's ``scripts/bench_1e6.py``).

    python -m raocp_tpu_torch.scripts.bench_1e6 [--stages 12] [--states 50]
        [--inputs 20] [--iters 50] [--unroll 5] [--tol 0] [--device cpu]

The problem (``bench_scale.tree_problem``): a 50-state, 20-input network on
a 3-mode chain fully branched for ``--stages`` stages, 12 by default:
797,161 nodes ((3^13 - 1) / 2), of which 265,720 nonleaf; the leaf stage is
531,441 rows. Every stage is stage-constant, so the device holds the
iterates and the stage tables, no dense per-node stacks, and every CP step
runs K1. The run, in float32: the loose power iteration of the JAX script
(1e-6: the step size needs a few digits), then ``--iters`` CP steps at
``check_every=25`` with tolerance 0; or, with ``--tol`` above 0, one solve
to that tolerance capped at ``MAX_ITERS`` (the iterations and seconds to
it). Prints one JSON line: the JAX script's
fields (``tree_seconds``, ``build_seconds``, ``iters``), the power
iteration's count and seconds, and ``bench_scale``'s fields (dtype, device,
card, K1 launches beside ``prox_f`` calls, peak device memory after the
build, the power iteration and the steps).
"""

import argparse
import json

from raocp_tpu_torch.scripts.bench_scale import run_tree

MAX_ITERS = 20000     # the cap of a solve to --tol
POWER_REL_TOL = 1e-6  # the JAX script's loose power iteration


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=12)
    ap.add_argument("--states", type=int, default=50)
    ap.add_argument("--inputs", type=int, default=20)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--unroll", type=int, default=5,
                    help="CP steps per trip of the loop (must divide "
                         "25); see bench_scale")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="solve to this residual tolerance once, capped at "
                         "MAX_ITERS (0: run --iters steps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    iters = MAX_ITERS if args.tol > 0 else args.iters
    row = run_tree(args.stages, args.states, args.inputs, iters=iters,
                   unroll=args.unroll, power_rel_tol=POWER_REL_TOL,
                   tol=args.tol, device=args.device).row
    print(json.dumps(row), flush=True)
    if not row["finite"]:
        raise SystemExit("the iterates are not finite")


if __name__ == "__main__":
    main()
