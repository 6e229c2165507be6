"""Speed-of-light accounting of the CP step on the card (counterpart of the
JAX package's ``scripts/roofline.py``).

    python -m raocp_tpu_torch.scripts.roofline [--stages 8|10|12]
        [--unroll 25] [--applies 100] [--traced 20]

The problem is the JAX script's: ``random_network_problem(50, 20, 3
modes, --stages stages)``, fully branched (9,841 nodes at 8, the headline;
88,573 at 10; 797,161 at 12), float32, ``offline="device"``. So are the
inputs: a random primal (x and u normal from ``numpy`` seed 0, the rest
zero), eta = L z (its leaves copied apart, as the loop's dual is), the
carried L z and L'eta, alpha = 0.01.

For each component of the step (L, L', K1's dynamics projection, the
kernel projection, ``prox_f``, the dual prox's projections, the step, the
step with its residuals, and one trip of the production loop per
iteration: ``--unroll`` steps, the residuals of the last, the host's read;
eagerly, and as the solver runs it on a card, replayed from the device
loop's CUDA graphs with the host reading the period's flag)
it prints one JSON line and a table row: the operations and compulsory
bytes (:mod:`raocp_tpu_torch.ops.work`), their intensity, the wall time of
an apply (CUDA events around ``--applies`` back-to-back applies, best of
three; each apply takes the previous one's outputs where it returns what
it takes, as the JAX script chains them, and on one stream no apply starts
before the previous one ends), the device time and launches of an apply
(a ``torch.profiler`` trace of ``--traced`` applies), the least time the
card could take (:func:`raocp_tpu_torch.ops.work.bound`) and the share of
it reached, against the device time and against the wall time. A device
time below the bound is a fault of the count. It needs a card.
"""

import argparse
import json
import math

import numpy as np
import torch

from raocp_tpu_torch.core.variables import Dual
from raocp_tpu_torch.ops import work
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import (g_conj_projections, half_shift_dual,
                                      project_dynamics, project_kernel,
                                      prox_f)
from raocp_tpu_torch.scripts.bench_configs import card
from raocp_tpu_torch.scripts.bench_scale import tree_problem
from raocp_tpu_torch.scripts.profile_step import traced_events
from raocp_tpu_torch.solver import (Solver, _cp_residuals, _cp_step,
                                    cp_iteration, pin_full_precision)

__all__ = ["NODES", "UNROLL", "problem", "inputs", "trip", "graph_trip",
           "components", "rows", "wall_us", "chain", "require_card"]

NODES = {8: 9841, 10: 88573, 12: 797161}
UNROLL = 25


def require_card(script: str) -> None:
    """Raise SystemExit where no card is available: a measurement made on
    the CPU would be no device metric."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{script} measures the card; no CUDA device is "
                         "available")


def problem(stages: int = 8, device="cuda"):
    """(stacked problem, x0) of the JAX script's network at ``stages``."""
    spec, x0 = tree_problem(stages)
    sp = Solver(spec, dtype=torch.float32, offline="device",
                device=device).stacked
    return sp, x0


def inputs(sp, x0, seed: int = 0) -> dict:
    """The JAX script's inputs on ``sp``'s device (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    z = sp.zero_primal()

    def normal(leaf):
        return torch.as_tensor(rng.standard_normal(tuple(leaf.shape)),
                               dtype=sp.dtype, device=sp.device)

    z = z._replace(x=normal(z.x), u=normal(z.u))
    eta = Dual(*(leaf.clone() for leaf in ell(sp, z)))

    def number(v):
        return torch.as_tensor(v, dtype=sp.dtype, device=sp.device)

    return dict(z=z, eta=eta, Lz=ell(sp, z), Lt=ell_t(sp, eta),
                a1=number(0.01), a2=number(0.01), x0=number(x0),
                shift=half_shift_dual(sp))


def trip(sp, z, eta, Lz, Lt, a1, a2, x0, shift, unroll: int = UNROLL):
    """One trip of the production loop (``solver._run_cp`` at
    ``check_every = unroll``): ``unroll`` steps, the residuals of the
    last, and the host's read of them. Returns the iterates and the
    residuals on the host."""
    for _ in range(unroll):
        prev = (z, eta, Lz, Lt)
        z, eta, Lz, Lt = _cp_step(sp, z, eta, Lz, Lt, a1, a2, x0, shift)
    err, derr = _cp_residuals(sp, prev[0], z, prev[1], eta, prev[2], Lz,
                              prev[3], Lt, a1, a2)
    return z, eta, Lz, Lt, torch.cat([err, derr]).cpu()


def graph_trip(sp, v: dict, unroll: int = UNROLL, capacity: int = 1 << 16):
    """An apply of one trip as the solver's device loop runs it on a card:
    a period of ``unroll`` steps (the residuals of the last, its history
    row, the running flag) replayed from the loop's CUDA graphs, the two
    carries taking turns, then the host's read of the flag. It starts from
    the inputs ``v`` (:func:`inputs`); the first apply captures."""
    from raocp_tpu_torch import solver as solver_mod

    loop = solver_mod._DeviceLoop(sp, v["z"], v["eta"], v["Lz"], v["Lt"],
                                  None, unroll, False, 1.0, capacity)
    loop.load(v["z"], v["eta"], v["Lz"], v["Lt"], v["x0"], v["a1"], v["a2"],
              0.0, capacity, 0, math.nan)
    done = [0]

    def apply():
        n = done[0]
        if (n + 1) * unroll > capacity:
            raise RuntimeError("the trip's history is full")
        loop.launch(sp, n)
        loop.flag(sp, n)
        done[0] = n + 1

    return apply


def chain(fn, *state):
    """An apply of ``fn`` that takes the previous apply's outputs (the
    first ``len(state)`` of them), starting from ``state``."""
    box = [state]

    def apply():
        box[0] = tuple(fn(*box[0]))[:len(state)]

    return apply


def components(sp, x0, unroll: int = UNROLL) -> list:
    """(row name, apply, its count, iterations an apply) for each row."""
    v = inputs(sp, x0)
    z, eta, a1, a2, x0t, shift = (v[k] for k in ("z", "eta", "a1", "a2",
                                                  "x0", "shift"))
    state = (z, eta, v["Lz"], v["Lt"])
    return [
        ("L apply", lambda: ell(sp, z), work.ell(sp), 1),
        ("L' apply", lambda: ell_t(sp, eta), work.ell_t(sp), 1),
        ("project_dynamics (K1)",
         chain(lambda x, u: project_dynamics(sp, x, u, x0t), z.x, z.u),
         work.project_dynamics(sp), 1),
        ("project_kernel",
         chain(lambda *s: project_kernel(sp, *s), z.y, z.tau, z.s),
         work.project_kernel(sp), 1),
        ("prox_f", chain(lambda zz: (prox_f(sp, zz, a1, x0t),), z),
         work.prox_f(sp), 1),
        ("g* projections",
         chain(lambda e: (g_conj_projections(sp, e),), eta),
         work.g_conj_projections(sp), 1),
        ("cp_step (2 applies + prox)",
         chain(lambda *s: _cp_step(sp, *s, a1, a2, x0t, shift), *state),
         work.cp_step(sp), 1),
        ("cp_iteration (step + residuals)",
         chain(lambda *s: cp_iteration(sp, *s, a1, a2, x0t, shift),
               *state),
         work.cp_iteration(sp), 1),
        ("production trip / iteration",
         chain(lambda *s: trip(sp, *s, a1, a2, x0t, shift, unroll), *state),
         work.production_trip(sp, unroll), unroll),
        ("production trip / iteration (graph)", graph_trip(sp, v, unroll),
         work.production_trip(sp, unroll), unroll),
    ]


def wall_us(apply, applies: int, repeats: int = 3) -> float:
    """µs an apply: CUDA events around ``applies`` back-to-back applies,
    the best of ``repeats``, after three applies of warm-up."""
    for _ in range(3):
        apply()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(applies):
            apply()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, 1e3 * start.elapsed_time(stop) / applies)
    return best


def rows(sp, x0, unroll: int = UNROLL, applies: int = 100,
         traced: int = 20) -> list:
    """One dict per component of :func:`components` on ``sp`` (a card's
    problem); a trip's numbers are per iteration, and it runs
    ``max(2, applies // unroll)`` timed and ``max(2, traced // unroll)``
    traced trips."""
    if sp.device.type != "cuda":
        raise RuntimeError("the roofline is measured on a card; the problem "
                           "is not on one")
    out = []
    for name, apply, count, per in components(sp, x0, unroll):
        n_wall = applies if per == 1 else max(2, applies // per)
        n_traced = traced if per == 1 else max(2, traced // per)
        wall = wall_us(apply, n_wall) / per
        events = traced_events(apply, n_traced)
        device = sum(ev["dur"] for ev in events) / n_traced / per
        bound_s, bound_by = work.bound(count, sp.dtype)
        bound = 1e6 * bound_s
        row = dict(component=name, nodes=sp.num_nodes, dtype=str(sp.dtype),
                   card=card(sp.device), **count,
                   intensity_flop_per_byte=count["flop"] / count["bytes"],
                   wall_us=wall, device_us=device,
                   launches=len(events) / n_traced / per,
                   bound_us=bound, bound_by=bound_by,
                   pct_of_bound_device=100 * bound / device,
                   pct_of_bound_wall=100 * bound / wall)
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, choices=sorted(NODES), default=8)
    ap.add_argument("--unroll", type=int, default=UNROLL)
    ap.add_argument("--applies", type=int, default=100)
    ap.add_argument("--traced", type=int, default=20)
    args = ap.parse_args(argv)
    require_card("roofline")
    pin_full_precision()
    sp, x0 = problem(args.stages)
    table = rows(sp, x0, args.unroll, args.applies, args.traced)
    for row in table:
        print(json.dumps(row), flush=True)
    print(f"\n{sp.num_nodes} nodes, float32; {card(sp.device)}; peaks "
          f"{work.PEAK_BYTES / 1e12:.2f} TB/s, "
          f"{work.PEAK_FLOPS[4] / 1e12:.0f} TFLOP/s")
    print(f"{'component':34s} {'MFLOP':>9s} {'MB':>8s} {'wall us':>9s} "
          f"{'dev us':>9s} {'launch':>7s} {'SOL us':>8s} {'%dev':>6s} "
          f"{'%wall':>6s}")
    for r in table:
        print(f"{r['component']:34s} {r['flop'] / 1e6:9.3f} "
              f"{r['bytes'] / 1e6:8.2f} {r['wall_us']:9.1f} "
              f"{r['device_us']:9.1f} {r['launches']:7.2f} "
              f"{r['bound_us']:8.2f} {r['pct_of_bound_device']:6.2f} "
              f"{r['pct_of_bound_wall']:6.2f}", flush=True)


if __name__ == "__main__":
    main()
