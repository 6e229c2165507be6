"""Where a CP step's time goes on the card: trace a solve with
``torch.profiler`` and add up the trace's device events (counterpart of the
JAX package's ``scripts/profile_step.py``).

    python -m raocp_tpu_torch.scripts.profile_step [--steps 100]
        [--config headline|config5|tree797161|headline_supermann|
                  headline_anderson]

``headline`` (BASELINE config 4: 9,841 nodes, float32) runs 100 CP steps
at ``check_every=25, unroll=25``; ``headline_supermann`` and
``headline_anderson`` 100 accelerated iterations of the same problem
(memory 5, ``check_every=25``); ``config5 (BASELINE config 5's
88,573-node per-step tree, float32) at the closed loop's
``check_every=25, unroll=5, relax="auto"``; ``tree797161`` (``bench_1e6``'s
797,161-node tree, float32) at its ``check_every=25, unroll=5``. Each
prints one JSON line: the trace's wall time and device busy time a step,
the card's busy share, the launches a step, K1's share of the device time
and the kernels that take most of it, each ``raocp.*`` span's self time
and the card's idle time by the span open in it, the host's reads a step,
and the Solver's power iteration (its count and seconds at the Solver's
own tolerance). It needs a card.
"""

import argparse
import heapq
import json
import os
import tempfile
import time

import torch

from raocp_tpu_torch import accel, models
from raocp_tpu_torch.ops.sweep import sweep_eligible
from raocp_tpu_torch.scripts.bench_configs import (CONFIG5, CONFIGS,
                                                   counted_calls, sync)
from raocp_tpu_torch.scripts.bench_scale import tree_problem
from raocp_tpu_torch import solver as solver_mod
from raocp_tpu_torch.solver import Solver

__all__ = ["PROFILES", "device_events", "is_k1", "profile_solve",
           "run_profile", "summarize_trace", "trace_events",
           "traced_call_events", "traced_events"]

# the device's own work in a torch.profiler Chrome trace
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(trace_path: str) -> list:
    """Every event of a Chrome trace."""
    with open(trace_path) as fh:
        return json.load(fh)["traceEvents"]


def device_events(trace_path: str) -> list:
    """The device events (kernels, copies, sets) of a Chrome trace."""
    return [ev for ev in trace_events(trace_path)
            if ev.get("cat") in _DEVICE_CATS]


def traced_events(fn, applies: int, attempts: int = 3) -> list:
    """The device events of a ``torch.profiler`` trace of ``applies``
    calls of ``fn``, after which the card is synchronised; the card idles
    ``solver.TRACE_PAD_S`` at both ends of the trace's window. A trace
    that holds no device event at all lost them and is taken again, up to
    ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(solver_mod.TRACE_PAD_S)
            for _ in range(applies):
                fn()
            torch.cuda.synchronize()
            time.sleep(solver_mod.TRACE_PAD_S)
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "trace.json")
            prof.export_chrome_trace(path)
            events = device_events(path)
        if events:
            break
    return events


def traced_call_events(fn, attempts: int = 3) -> list:
    """The device events of a ``torch.profiler`` trace of one call of
    ``fn`` (which ends with the card synchronised) that fall inside the
    call's host range, one a kernel. The card's tracer can hand a trace
    records of kernels that ran before it began (seen on an H100 after
    other traces in the process), which the range leaves out. A trace
    with no device event in the range is taken again, up to ``attempts``
    times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(solver_mod.TRACE_PAD_S)
            with record_function("raocp.traced_call"):
                fn()
                torch.cuda.synchronize()
            time.sleep(solver_mod.TRACE_PAD_S)
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        (span,) = [ev for ev in events if ev.get("cat") == "user_annotation"
                   and ev["name"] == "raocp.traced_call"]
        # one record a kernel: (name, start, duration) on the device
        inside = list({(ev["name"], ev["ts"], ev.get("dur")): ev
                       for ev in events if ev.get("cat") in _DEVICE_CATS
                       and span["ts"] <= ev["ts"]
                       <= span["ts"] + span["dur"]}.values())
        if inside:
            break
    return inside


def is_k1(name: str) -> bool:
    """A kernel of K1 (``csrc/sweep.cu``'s stage and apex launches)."""
    return "stage_kernel" in name or "apex_kernel" in name


def _union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _span_self_us(spans) -> dict:
    """Self time by name of nested spans ((start, end, name), us): each
    span's length less that of the spans directly inside it."""
    out, stack = {}, []             # open: [end, name, length, inner]

    def close():
        end, name, length, inner = stack.pop()
        out[name] = out.get(name, 0.0) + length - inner

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and b > stack[-1][0]:
            close()
        if stack:
            stack[-1][3] += b - a
        stack.append([b, name, b - a, 0.0])
    while stack:
        close()
    return out


def _idle_by_span(gaps, spans) -> dict:
    """Idle time by the innermost span open at each gap's middle (the one
    started last of those open), ``"none"`` where no span is open: a sweep
    in time with a heap of the spans started so far."""
    spans = sorted(spans)
    out, heap, i = {}, [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "none"
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def summarize_trace(events: list, steps: int, top: int = 8) -> dict:
    """Of a Chrome trace's events (its device events: kernels, copies,
    sets; and the package's ``raocp.*`` spans), per step of ``steps``: the
    wall time from the first device event's start to the last one's end,
    the device's busy time (the length of the union of the device events'
    intervals, so events that overlap count once) and its share of the
    wall time, the device events, K1's time and share of the device
    events' summed time, and the ``top`` kernels by time; the self time of
    each ``raocp.*`` span (its time less that of the spans inside it), and
    the card's idle time inside the wall by the innermost ``raocp.*`` span
    open at each idle gap's middle (``"none"`` where none is open)."""
    device = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
    if not device:
        raise ValueError("the trace holds no device event")
    by_name = {}                                # name -> [us, launches]
    for ev in device:
        entry = by_name.setdefault(ev["name"], [0.0, 0])
        entry[0] += ev["dur"]
        entry[1] += 1
    summed_us = sum(t for t, _ in by_name.values())
    busy = _union((ev["ts"], ev["ts"] + ev["dur"]) for ev in device)
    busy_us = sum(b - a for a, b in busy)
    wall_us = busy[-1][1] - busy[0][0]
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    spans = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in events
             if ev.get("cat") == "user_annotation"
             and ev["name"].startswith("raocp.")]
    k1_us = sum(t for name, (t, _) in by_name.items() if is_k1(name))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]

    def per_step(us_by_name):
        return {name: 1e-3 * us / steps
                for name, us in sorted(us_by_name.items())}

    return dict(
        steps=steps, wall_ms_per_step=1e-3 * wall_us / steps,
        device_ms_per_step=1e-3 * busy_us / steps,
        device_busy_share=busy_us / wall_us,
        launches_per_step=len(device) / steps,
        k1_ms_per_step=1e-3 * k1_us / steps,
        k1_share_of_device=k1_us / summed_us,
        top_kernels=[dict(name=name[:60], ms_per_step=1e-3 * t / steps,
                          launches_per_step=c / steps,
                          share_of_device=t / summed_us)
                     for name, (t, c) in ranked],
        span_self_ms_per_step=per_step(_span_self_us(spans)),
        idle_ms_per_step_by_span=per_step(_idle_by_span(gaps, spans)))


def profile_solve(solver: Solver, x0, steps: int, **options) -> dict:
    """``steps`` CP steps of ``solver`` from ``x0`` (tolerance 1e-12, so
    every step runs; a multiple of the check period, so that the device
    loop runs no eager tail) under ``solve(profile_dir=...)``, after one
    untraced
    solve of the same steps (K1's packing, the allocator's warm-up, the
    graphs' capture): the trace's :func:`summarize_trace`, beside the
    traced solve's K1 launches, ``prox_f`` calls and the device loop's
    replays and host reads."""
    if solver.stacked.device.type != "cuda":
        raise RuntimeError("the step's profile reads the card's trace; the "
                           "solver is not on a card")
    # the loop's cap runs unroll * ceil((max_iters + 2 - unroll) / unroll)
    # steps: exactly ``steps`` (whole check periods, no eager tail, where
    # they divide it)
    unroll = options.get("unroll", 1)
    opts = dict(max_iters=steps + unroll - 2, tol=1e-12, **options)
    # an accelerated solve's loop counts its iterations and host reads in
    # accel.LOOP_COUNTS
    counts, steps_key = ((accel.LOOP_COUNTS, "iterations")
                         if options.get("accel") else
                         (solver_mod.LOOP_COUNTS, "steps"))
    solver.solve(x0, **opts)
    before = dict(counts)
    with tempfile.TemporaryDirectory() as folder, counted_calls() as calls:
        res = solver.solve(x0, profile_dir=folder, **opts)
        events = trace_events(os.path.join(folder, "trace.json"))
    ran = {k: counts[k] - before[k]
           for k in ("replays", "host_reads", steps_key)}
    return dict(summarize_trace(events, res.num_iters),
                nodes=solver.stacked.num_nodes,
                dtype=str(solver.stacked.dtype),
                device=str(solver.stacked.device),
                k1_path=sweep_eligible(solver.stacked),
                k1_launches=calls["k1"], prox_f_calls=calls["prox_f"],
                graph_replays=ran["replays"],
                device_loop_steps=ran[steps_key],
                host_reads_per_step=ran["host_reads"] / res.num_iters,
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
    "headline_supermann": (_headline, dict(accel="supermann",
                                           accel_memory=5, check_every=25)),
    "headline_anderson": (_headline, dict(accel="anderson", accel_memory=5,
                                          check_every=25)),
}


def run_profile(name: str = "headline", steps: int = 100,
                device="cuda") -> dict:
    """The step profile of ``PROFILES[name]`` on ``device`` (a card)
    (:func:`profile_solve`)."""
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
