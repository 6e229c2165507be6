"""Per-component timing of the CP step on the card at the headline
(BASELINE config 4: 9,841 nodes, float32; counterpart of the JAX package's
``scripts/bench_components.py``).

    python -m raocp_tpu_torch.scripts.bench_components [--applies 50]

Times one apply of each piece of a Chambolle-Pock step: L and L', the
dynamics projection (K1 on the card), the kernel projection, ``prox_f``,
the dual cone projections, a max-norm, the step itself and a full
iteration with its residuals (read back to the host, as the loop does at
every check). For each it prints the wall time of one apply (the median of
back-to-back applies, each between two CUDA events: on a host-bound
component the events wait for the host, so this is dispatch and device
together) beside its device time and launches, both from a
``torch.profiler`` trace of the same applies. The gap between the two is
the host's share. It needs a card.
"""

import argparse
import json

import numpy as np
import torch

from raocp_tpu_torch.core.variables import Primal, tree_inf_norm
from raocp_tpu_torch.ops.operator import ell, ell_t
from raocp_tpu_torch.ops.prox import (g_conj_projections, half_shift_dual,
                                      project_dynamics, project_kernel,
                                      prox_f)
from raocp_tpu_torch.scripts.bench_configs import CONFIGS
from raocp_tpu_torch.scripts.profile_step import traced_events
from raocp_tpu_torch.solver import Solver, _cp_step, cp_iteration

__all__ = ["components", "time_components"]


def components(sp, seed: int = 0) -> dict:
    """name -> a callable that applies that component once to fixed
    inputs: a primal of ``numpy.random.default_rng(seed)`` normals, its
    image under L, a step size of 0.01 and the problem's x0 row."""
    rng = np.random.default_rng(seed)
    z = Primal(*(torch.as_tensor(rng.standard_normal(tuple(l.shape)),
                                 dtype=sp.dtype, device=sp.device)
                 for l in sp.zero_primal()))
    eta = ell(sp, z)
    Lz, Lt = eta, ell_t(sp, eta)
    x0 = z.x[0].clone()
    a = torch.as_tensor(0.01, dtype=sp.dtype, device=sp.device)
    shift = half_shift_dual(sp)

    def iteration():
        err, derr = cp_iteration(sp, z, eta, Lz, Lt, a, a, x0, shift)[4:]
        return torch.cat([err, derr]).cpu()

    return {
        "L": lambda: ell(sp, z),
        "L'": lambda: ell_t(sp, eta),
        "project_dynamics": lambda: project_dynamics(sp, z.x, z.u, x0),
        "project_kernel": lambda: project_kernel(sp, z.y, z.tau, z.s),
        "prox_f": lambda: prox_f(sp, z, a, x0),
        "g_conj_projections": lambda: g_conj_projections(sp, eta),
        "max-norm": lambda: tree_inf_norm(z),
        "_cp_step": lambda: _cp_step(sp, z, eta, Lz, Lt, a, a, x0, shift),
        "iteration with residuals": iteration,
    }


def _wall_ms(fn, applies: int) -> float:
    """The median over ``applies`` back-to-back applies of the time
    between CUDA events around each."""
    times = []
    for _ in range(applies):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _traced(fn, applies: int):
    """Device ms and device events per apply, from a trace of ``applies``
    applies."""
    events = traced_events(fn, applies)
    return (1e-3 * sum(ev["dur"] for ev in events) / applies,
            len(events) / applies)


def time_components(sp, applies: int = 50) -> list:
    """One row per component of :func:`components` on ``sp`` (a card's
    problem): wall ms, device ms and launches per apply."""
    if sp.device.type != "cuda":
        raise RuntimeError("the components are timed on a card; the "
                           "problem is not on one")
    rows = []
    for name, fn in components(sp).items():
        for _ in range(5):                      # warm up (K1's packing)
            fn()
        torch.cuda.synchronize()
        wall = _wall_ms(fn, applies)
        device_ms, launches = _traced(fn, applies)
        rows.append(dict(component=name, wall_ms=wall, device_ms=device_ms,
                         launches=launches,
                         host_share=max(0.0, 1.0 - device_ms / wall)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--applies", type=int, default=50)
    args = ap.parse_args(argv)
    problem, _ = CONFIGS[4].make()
    sp = Solver(problem, dtype=torch.float32, offline="device").stacked
    for row in time_components(sp, args.applies):
        print(json.dumps(dict(nodes=sp.num_nodes, **row)), flush=True)


if __name__ == "__main__":
    main()
