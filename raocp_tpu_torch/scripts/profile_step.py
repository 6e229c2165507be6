"""Where a CP step's time goes on the card: trace a solve with
``torch.profiler`` and sum the trace's device events (counterpart of the
JAX package's ``scripts/profile_step.py``).

    python -m raocp_tpu_torch.scripts.profile_step [--steps 100]
        [--config headline|config5|tree797161]

``headline`` (BASELINE config 4: 9,841 nodes, float32) runs 100 CP steps
at ``check_every=25, unroll=25``; ``config5`` (BASELINE config 5's
88,573-node per-step tree, float32) at the closed loop's
``check_every=25, unroll=5, relax="auto"``; ``tree797161`` (``bench_1e6``'s
797,161-node tree, float32) at its ``check_every=25, unroll=5``. Each
prints one JSON line: the trace's wall time and device time a step, the
card's busy share, the launches a step, K1's share of the device time and
the kernels that take most of it, and the Solver's power iteration (its
count and seconds at the Solver's own tolerance). It needs a card.
"""

import argparse
import json
import os
import tempfile
import time

import torch

from raocp_tpu_torch import models
from raocp_tpu_torch.ops.sweep import sweep_eligible
from raocp_tpu_torch.scripts.bench_configs import (CONFIG5, CONFIGS,
                                                   counted_calls, sync)
from raocp_tpu_torch.scripts.bench_scale import tree_problem
from raocp_tpu_torch.solver import Solver

__all__ = ["PROFILES", "device_events", "is_k1", "profile_solve",
           "run_profile", "summarize_trace", "traced_events"]

# the device's own work in a torch.profiler Chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_path: str) -> list:
    """The device events (kernels, copies, sets) of a Chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [ev for ev in events if ev.get("cat") in _DEVICE_CATS]


def traced_events(fn, applies: int) -> list:
    """The device events of a ``torch.profiler`` trace of ``applies``
    calls of ``fn``, after which the card is synchronised."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(applies):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as folder:
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        return device_events(path)


def is_k1(name: str) -> bool:
    """A kernel of K1 (``csrc/sweep.cu``'s stage and apex launches)."""
    return "stage_kernel" in name or "apex_kernel" in name


def summarize_trace(events: list, steps: int, top: int = 8) -> dict:
    """Per step of ``steps``: the wall time from the first device event's
    start to the last one's end, the device time (the events' durations
    summed), the card's busy share of the wall time, the device events, K1's
    time and share of the device time, and the ``top`` kernels by time."""
    if not events:
        raise ValueError("the trace holds no device event")
    by_name = {}                                # name -> [us, launches]
    for ev in events:
        entry = by_name.setdefault(ev["name"], [0.0, 0])
        entry[0] += ev["dur"]
        entry[1] += 1
    busy_us = sum(t for t, _ in by_name.values())
    wall_us = max(ev["ts"] + ev["dur"] for ev in events) \
        - min(ev["ts"] for ev in events)
    k1_us = sum(t for name, (t, _) in by_name.items() if is_k1(name))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(
        steps=steps, wall_ms_per_step=1e-3 * wall_us / steps,
        device_ms_per_step=1e-3 * busy_us / steps,
        device_busy_share=busy_us / wall_us,
        launches_per_step=sum(c for _, c in by_name.values()) / steps,
        k1_ms_per_step=1e-3 * k1_us / steps,
        k1_share_of_device=k1_us / busy_us,
        top_kernels=[dict(name=name[:60], ms_per_step=1e-3 * t / steps,
                          launches_per_step=c / steps,
                          share_of_device=t / busy_us)
                     for name, (t, c) in ranked])


def profile_solve(solver: Solver, x0, steps: int, **options) -> dict:
    """``steps`` CP steps of ``solver`` from ``x0`` (tolerance 1e-12, so
    every step runs) under ``solve(profile_dir=...)``, after one untraced
    solve of the same steps (K1's packing, the allocator's warm-up): the
    trace's :func:`summarize_trace`, beside the traced solve's K1 launches
    and ``prox_f`` calls."""
    if solver.stacked.device.type != "cuda":
        raise RuntimeError("the step's profile reads the card's trace; the "
                           "solver is not on a card")
    opts = dict(max_iters=steps, tol=1e-12, **options)
    solver.solve(x0, **opts)
    with tempfile.TemporaryDirectory() as folder, counted_calls() as calls:
        res = solver.solve(x0, profile_dir=folder, **opts)
        events = device_events(os.path.join(folder, "trace.json"))
    return dict(summarize_trace(events, res.num_iters),
                nodes=solver.stacked.num_nodes,
                dtype=str(solver.stacked.dtype),
                device=str(solver.stacked.device),
                k1_path=sweep_eligible(solver.stacked),
                k1_launches=calls["k1"], prox_f_calls=calls["prox_f"],
                options=options)


def _headline(device):
    problem, x0 = CONFIGS[4].make()
    return Solver(problem, dtype=torch.float32, offline="device",
                  device=device), x0


def _config5(device):
    controller, x0 = models.network_mpc_controller(
        **CONFIG5, dtype=torch.float32, offline="device", device=device)
    return controller.solver_for_mode(0)[0], x0


def _tree797161(device):
    problem, x0 = tree_problem(12)
    return Solver(problem, dtype=torch.float32, offline="device",
                  device=device), x0


# name -> (solver maker, the loop's options)
PROFILES = {
    "headline": (_headline, dict(check_every=25, unroll=25)),
    "config5": (_config5, dict(check_every=25, unroll=5, relax="auto")),
    "tree797161": (_tree797161, dict(check_every=25, unroll=5)),
}


def run_profile(name: str = "headline", steps: int = 100,
                device="cuda") -> dict:
    """The step profile of ``PROFILES[name]`` on ``device`` (a card)."""
    make, options = PROFILES[name]
    solver, x0 = make(device)
    sync(device)
    tic = time.perf_counter()
    solver.operator_norm_sq()
    sync(device)
    power_s = time.perf_counter() - tic
    return dict(profile=name, power_iterations=solver.power_iterations,
                power_seconds=power_s,
                **profile_solve(solver, x0, steps, **options))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--config", choices=sorted(PROFILES), default="headline")
    args = ap.parse_args(argv)
    print(json.dumps(run_profile(args.config, args.steps)), flush=True)


if __name__ == "__main__":
    main()
