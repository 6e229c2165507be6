"""Smoke run of raocp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # the smoke run (about 6 minutes)
    python3 chip_smoke.py --baseline    # BASELINE configs 3-5 to 1e-3
    python3 chip_smoke.py --profile     # where a config-5 CP step's time goes

Builds the port's CUDA kernel (K1, the dynamics-projection sweep) from
``raocp_tpu_torch/csrc``, holds it against its plain torch version on the
card (at the shapes of every path below, BASELINE config 5's width and
batches of 8 and 3 lanes included; each case with its time, the plain
version's, the least time the card could take for the same operations and
bytes, and its launches counted in a profile), and then drives the port's
paths, each with the launch counts set to 0 just before it and read just
after:

* ``parity_*``: the demo's 937 iterations in float64 on the card, and a
  uniform 121-node tree through K1 against the CPU;
* ``chunked_demo_f64``: the demo in 300-iteration chunks, the same history;
* ``headline_f32``: ``Solver(problem).solve(x0)`` (the card is the default
  device) at the
  50-state, 20-input, 3-mode, 8-stage (9,841-node) configuration;
* ``mpc_config5_f32``: ``network_mpc_controller(offline="device")`` at
  BASELINE config 5's full size (100 states, 40 inputs, 88,573 nodes),
  two closed-loop steps;
* ``accel_headline_f32``: SuperMann on the headline; SuperMann on the
  uniform tree (through K1) and Anderson on the demo, in float64 against
  the CPU port (the same T evaluations and iterates over the first 80 /
  60 iterations), and Anderson's convergence after;
* ``batch_demo_f64``: ``solve_batch`` on the demo's three lanes in float64
  (lane 0: 937 iterations, every lane converged and valid);
* ``batch_headline_f32``: ``Solver(problem).solve_batch(x0s, ...)`` of the
  headline from ``scripts/bench_batch.py``'s eight initial states, capped
  at 2,500 iterations: one K1 launch set per ``prox_f`` call, lane 0's
  history against a single card solve, and the batch's rate beside the
  single solve's.

It prints one JSON line per phase, the kernel table, the card's name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises; without a CUDA device it fails before printing anything. It imports
no JAX. ``--baseline`` runs, instead of the smoke phases, the BASELINE
config-4 SuperMann solve and the config-5 closed loop to tolerance 1e-3
(``--config5-steps``, default 1), and ``scripts/bench_batch.py``'s two
measurements on the card: eight lanes of the headline (in float32 and in
float64) and of config 3 to 1e-3 in one batch against eight sequential
solves. ``--profile`` runs 100 CP steps of config 5 with
``solve(profile_dir=...)`` and prints, from that trace, the card's busy
share of the step and its kernels by time.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.accel as accel_mod  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.models import (demo_problem,  # noqa: E402
                                    network_mpc_controller,
                                    random_network_problem,
                                    soc_network_problem)
from raocp_tpu_torch.ops import sweep  # noqa: E402

DEV = torch.device("cuda", 0)
SMALL = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
             stopping_time=4)
HEADLINE = dict(num_states=50, num_inputs=20, num_modes=3, num_stages=8,
                stopping_time=8)
# BASELINE config 5's width (4 stages, 40 nodes) and its full
# 88,573-node tree
CONFIG5_WIDTH = dict(num_states=100, num_inputs=40, num_modes=3,
                     num_stages=3, stopping_time=3)
CONFIG5 = dict(num_states=100, num_inputs=40, num_modes=3, num_stages=10,
               stopping_time=10)
# the JAX package's float32 count on this problem (BENCH_configs_r05.jsonl,
# config 4): context only, not asserted
JAX_F32_ITERS = 10174
# K1 launches of each driven path
PATH_LAUNCHES = {}
# the card's published peaks (NVIDIA H100 SXM data sheet), by element size:
# FLOP/s of FMA in that type without loss of digits (float32 outside the
# tensor cores; float64 through the tensor cores' DMMA, which rounds like
# fma and so is open to the kernel, at twice the 34e12 of the FMA pipes),
# and bytes/s of device memory
PEAK_FLOPS = {4: 67e12, 8: 67e12}
PEAK_BYTES = 3.35e12
# how far, as a share of its sequential count, a float32 lane's count may
# be from its sequential solve's to 1e-3 (baseline_batch)
F32_COUNT_SLACK = 0.1


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def counted(path=None):
    """Set the K1 launch count to 0 and count ``prox_f`` calls (the T
    evaluations of a CP step) while a path runs; read both after it, and
    keep the launches under ``path``."""
    calls = {"prox_f": 0}
    real = solver_mod.prox_f

    def counting_prox_f(*args, **kwargs):
        calls["prox_f"] += 1
        return real(*args, **kwargs)

    torch.cuda.synchronize()
    sweep.LAUNCHES = 0
    solver_mod.prox_f = counting_prox_f
    try:
        yield calls
    finally:
        solver_mod.prox_f = real
        torch.cuda.synchronize()
    calls["k1"] = sweep.LAUNCHES
    if path is not None:
        PATH_LAUNCHES[path] = calls["k1"]


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    solver_mod.pin_full_precision()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    return smi


def phase_build():
    tic = time.perf_counter()
    lib = sweep.build_library()
    emit("build", kernel="K1 sweep", library=str(lib.name),
         seconds=time.perf_counter() - tic)


def bench_lanes(x0, lanes=8):
    """``scripts/bench_batch.py``'s initial states: (0.5 + r) x0, r from
    ``numpy.random.default_rng(0)``."""
    x0 = np.asarray(x0, dtype=np.float64)
    return np.stack([s * x0 for s in
                     0.5 + np.random.default_rng(0).random(lanes)])


def _sweep_inputs(kwargs, dtype, pad, lanes=None):
    """A problem and K1's inputs on the card: x [np_pad, n], u [nl_pad, m]
    and x0 [n], or with ``lanes`` x [B, np_pad, n], u [B, nl_pad, m] and
    x0 [B, n]."""
    spec, x0 = random_network_problem(**kwargs)
    sp = build_stacked(spec, dtype=dtype, pad_multiple=pad, device=DEV)
    rng = np.random.default_rng(0)
    lead = () if lanes is None else (lanes,)
    x_in = torch.as_tensor(rng.standard_normal(lead + (sp.np_pad, sp.n)),
                           dtype=dtype, device=DEV)
    u_in = torch.as_tensor(rng.standard_normal(lead + (sp.nl_pad, sp.m)),
                           dtype=dtype, device=DEV)
    x0 = x0 if lanes is None else bench_lanes(x0, lanes)
    return sp, x_in, u_in, torch.as_tensor(x0, dtype=dtype, device=DEV)


def _k1_profile(fn, applies=1, attempts=3):
    """K1 on the card per call of ``fn``, from a profile of ``applies``
    calls: the kernels it launches, and their device time in ms. ``fn``
    launches K1 alone, so a trace without any device kernel lost its
    device events (it happened once on the card, on a launch whose results
    were right): that profile is taken again, up to ``attempts`` times in
    all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(applies):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = [ev for ev in events if ev.get("cat") == "kernel"]
        if kernels:
            break
    k1 = [ev for ev in kernels
          if "stage_kernel" in ev["name"] or "apex_kernel" in ev["name"]]
    return len(k1) / applies, 1e-3 * sum(ev["dur"] for ev in k1) / applies


def _median_ms(fn, runs=50):
    for _ in range(5):                      # warm up
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _plan_fields(sp, lanes=1):
    """The schedule of one apply of ``lanes`` lanes, and the least time the
    card could take for its work: the larger of its operations over the
    peak FMA rate of the element type and its compulsory bytes over the
    memory rate."""
    plan = sweep.sweep_schedule(sp, lanes)
    work = sweep.sweep_work(sp, lanes)
    esize = sweep._esize(sp.dtype)
    by = {"operations": work["flop"] / PEAK_FLOPS[esize],
          "bytes": work["bytes"] / PEAK_BYTES}
    bound_by = max(by, key=by.get)
    return dict(
        lanes=lanes, launches_per_apply=plan["launch_count"],
        apex_stages=plan["apex_stages"], apex_tile=plan["apex_tile"],
        apex_grid=lanes,
        stage_launches=" ".join(
            f"{la['direction'][0]}{la['stages'][0]}:tm{la['tm']}"
            f"xt{la['tile']}xg{la['grid']}"
            for la in plan["launches"] if la["kind"] == "stage"),
        flop=work["flop"], bytes=work["bytes"],
        bound_ms=1e3 * by[bound_by], bound_by=bound_by,
        # no single PyTorch call computes the sweep: the plain version is
        # about eight calls per stage
        library_ms=None)


def phase_matmul_context():
    """Context only: one ``torch.matmul`` on the one largest product of
    config 5's sweep. The port never calls it."""
    a = torch.randn(19683, 300, device=DEV)
    b = torch.randn(300, 140, device=DEV)
    ms = _median_ms(lambda: torch.matmul(a, b))
    emit("context_matmul", shape="[19683, 300] x [300, 140]",
         dtype="torch.float32", ms=ms, flop=2 * 19683 * 300 * 140,
         tflops=2 * 19683 * 300 * 140 / (1e-3 * ms) / 1e12,
         note="the largest single product of config 5's sweep through "
              "torch.matmul, as a yardstick; the port never calls it")


def phase_kernel():
    """K1 against its plain version on the card, unbatched and batched.
    The error is relative to the output's inf-norm; ghost rows must be
    exactly zero in every lane; a second apply on the same buffers must
    give the same bits; the kernels one apply puts on the card (counted in
    a profile of 20 applies, which also gives their device time) must be
    the schedule's. A batch's lanes are also held
    against the unbatched kernel on each lane, and one lane must be the
    unbatched call to the bit."""
    odd_width = dict(HEADLINE, num_inputs=18)
    cases = (("a_small_f64", SMALL, torch.float64, 4, 1e-12, None),
             ("b_small_f32", SMALL, torch.float32, 4, 1e-5, None),
             # 8 sequential stages of up to c*n+m = 170-term float32 sums,
             # summed in another order than cuBLAS's
             ("c_headline_f32", HEADLINE, torch.float32, 8, 1e-4, None),
             # config 5's width: the widest rows, 40 nodes
             ("d_config5_width_f64", CONFIG5_WIDTH, torch.float64, 4, 1e-12,
              None),
             ("e_config5_width_f32", CONFIG5_WIDTH, torch.float32, 4, 1e-4,
              None),
             # the shapes the mpc_config5_f32 path hands K1: 88,573 nodes,
             # parent stages of up to 19,683 rows, persistent blocks
             ("f_config5_full_f32", CONFIG5, torch.float32, 1, 1e-4, None),
             ("g_headline_f64", HEADLINE, torch.float64, 8, 1e-12, None),
             # m no multiple of 4 (rows of 72 bytes: 8-byte copies, scalar
             # stores), stages that are no multiples of their tiles, node
             # spaces padded to multiples of 5
             ("h_odd_width_f32", odd_width, torch.float32, 5, 1e-4, None),
             # the shapes the batch_headline_f32 path hands K1: 8 lanes,
             # 78,728 rows; and the uniform tree in 3 lanes of float64
             ("i_headline_b8_f32", HEADLINE, torch.float32, 8, 1e-6, 8),
             ("j_small_b3_f64", SMALL, torch.float64, 4, 1e-14, 3))
    # a lane of a batch against the unbatched kernel: tiles of other rows,
    # so split-K sums in another order
    lane_tol = {torch.float32: 1e-6, torch.float64: 1e-14}
    out = {}
    for name, kwargs, dtype, pad, tol, lanes in cases:
        sp, x_in, u_in, x0 = _sweep_inputs(kwargs, dtype, pad, lanes)
        check(sweep.sweep_eligible(sp), f"{name}: not sweep-eligible")
        before = sweep.LAUNCHES
        x, u = sweep.project_dynamics_sweep(sp, x_in, u_in, x0)
        torch.cuda.synchronize()
        check(sweep.LAUNCHES == before + 1,
              f"K1 {name}: one apply counted {sweep.LAUNCHES - before}")
        x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, x_in, u_in, x0)
        err = max(float((x - x_ref).abs().max()),
                  float((u - u_ref).abs().max()))
        scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
        ghosts_zero = bool(torch.all(x[..., sp.num_nodes:, :] == 0)
                           and torch.all(u[..., sp.num_nonleaf:, :] == 0))
        finite = bool(torch.isfinite(x).all() and torch.isfinite(u).all())
        x2, u2 = sweep.project_dynamics_sweep(sp, x_in, u_in, x0)
        same_bits = bool(torch.equal(x, x2) and torch.equal(u, u2))
        row = dict(case=name, nodes=sp.num_nodes, n=sp.n, m=sp.m,
                   dtype=str(dtype), pad_multiple=pad, max_abs_err=err,
                   ref_inf_norm=scale, rel_err=err / scale, tol=tol,
                   ghost_rows_zero=ghosts_zero, second_apply_same=same_bits,
                   **_plan_fields(sp, lanes or 1))
        row["device_launches_per_apply"], row["device_ms"] = _k1_profile(
            lambda: sweep.project_dynamics_sweep(sp, x_in, u_in, x0), 20)
        if lanes is not None:
            lane_err = 0.0
            for b in range(lanes):
                xb, ub = sweep.project_dynamics_sweep(sp, x_in[b], u_in[b],
                                                      x0[b])
                lane_err = max(lane_err, float((x[b] - xb).abs().max()),
                               float((u[b] - ub).abs().max()))
            row["lane_vs_unbatched_rel_err"] = lane_err / scale
            # a batch of one lane against the unbatched call on lane 0
            x1, u1 = sweep.project_dynamics_sweep(sp, x_in[:1], u_in[:1],
                                                  x0[:1])
            xs, us = sweep.project_dynamics_sweep(sp, x_in[0], u_in[0],
                                                  x0[0])
            row["one_lane_same_bits"] = bool(torch.equal(x1[0], xs)
                                             and torch.equal(u1[0], us))
        row["ms"] = _median_ms(
            lambda: sweep.project_dynamics_sweep(sp, x_in, u_in, x0))
        row["plain_ms"] = _median_ms(
            lambda: sweep.project_dynamics_sweep_ref(sp, x_in, u_in, x0))
        row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        emit("kernel_vs_plain", **row)
        check(finite and err <= tol * scale,
              f"K1 {name}: error {err} above {tol} x {scale}")
        check(ghosts_zero, f"K1 {name}: ghost rows not zero")
        check(same_bits, f"K1 {name}: two applies differ")
        ns_nl = sp.num_stages - 1
        check(row["launches_per_apply"]
              == 2 * (ns_nl - row["apex_stages"]) + 1 <= 2 * ns_nl - 1
              and row["device_launches_per_apply"]
              == row["launches_per_apply"],
              f"K1 {name}: {row['launches_per_apply']} launches planned "
              f"for {ns_nl} stages, {row['apex_stages']} in the apex; "
              f"{row['device_launches_per_apply']} on the card")
        if lanes is not None:
            check(row["lane_vs_unbatched_rel_err"] <= lane_tol[dtype],
                  f"K1 {name}: a lane differs from the unbatched kernel by "
                  f"{row['lane_vs_unbatched_rel_err']}")
            check(row["one_lane_same_bits"],
                  f"K1 {name}: one lane is not the unbatched call")
        out[name] = row
    return out


def phase_parity():
    # the demo (a ragged tree: the torch branches) on the card, float64
    problem, x0 = demo_problem()
    demo = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
        x0, max_iters=2000, tol=1e-3)
    emit("parity_demo_f64", iters=demo.num_iters, xi=demo.xi.tolist())
    check(demo.converged and demo.num_iters == 937,
          f"demo took {demo.num_iters} iterations, not 937")
    check(np.allclose(demo.xi, [9.9508e-4, 9.4106e-4, 9.5599e-4], rtol=1e-3,
                      atol=0), f"demo xi {demo.xi}")
    # the uniform fixture: K1 on the card against the plain version on CPU
    problem, x0 = random_network_problem(**SMALL)
    with counted("parity_small_f64") as calls:
        gpu = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
            x0, max_iters=20000, tol=1e-3)
    cpu = rt.Solver(problem, dtype=torch.float64, device="cpu").solve(
        x0, max_iters=20000, tol=1e-3)
    emit("parity_small_f64", gpu_iters=gpu.num_iters,
         cpu_iters=cpu.num_iters, gpu_objective=gpu.objective,
         cpu_objective=cpu.objective, k1_launches=calls["k1"])
    check(gpu.converged and gpu.num_iters == cpu.num_iters,
          "CUDA and CPU iteration counts differ")
    check(abs(gpu.objective - cpu.objective) <= 1e-9,
          "CUDA and CPU objectives differ")
    check(calls["k1"] == gpu.num_iters, "K1 not launched once per CP step")
    return demo


def phase_chunked(demo):
    """The demo in 300-iteration chunks on the card: 937 iterations and the
    unchunked card run's history."""
    problem, x0 = demo_problem()
    tic = time.perf_counter()
    res = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
        x0, max_iters=2000, tol=1e-3, alpha=demo.alpha, chunk_iters=300)
    diff = float(np.abs(res.xi_history - demo.xi_history).max()) \
        if res.xi_history.shape == demo.xi_history.shape else float("inf")
    emit("chunked_demo_f64", iters=res.num_iters, chunk_iters=300,
         max_history_diff=diff, seconds=time.perf_counter() - tic)
    check(res.converged and res.num_iters == 937,
          f"chunked demo took {res.num_iters} iterations, not 937")
    check(diff <= 1e-12, f"chunked history differs by {diff}")


def phase_headline():
    problem, x0 = random_network_problem(**HEADLINE)
    torch.cuda.reset_peak_memory_stats()
    with counted("headline_f32") as calls:
        tic = time.perf_counter()
        solver = rt.Solver(problem)         # the default device: the card
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tic
        tic = time.perf_counter()
        solver.operator_norm_sq()
        power_s = time.perf_counter() - tic
        res = solver.solve(x0, max_iters=20000, tol=1e-3, check_every=25)
    sp = solver.stacked
    check(sp.device.type == "cuda", "the default device is not the card")
    finite = all(np.isfinite(v).all() for v in res.primal)
    emit("headline_f32", nodes=sp.num_nodes, n=sp.n, m=sp.m,
         dtype=str(sp.dtype), device=str(sp.device), build_stacked_s=build_s,
         power_iteration_s=power_s,
         power_iterations=solver.power_iterations, cp_iters=res.num_iters,
         jax_f32_iters_for_context=JAX_F32_ITERS, solve_s=res.solve_time,
         iters_per_second=res.iters_per_second, xi=res.xi.tolist(),
         objective=res.objective, k1_launches=calls["k1"],
         prox_f_calls=calls["prox_f"],
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    check(res.converged and np.isfinite(res.xi).all() and finite,
          "headline solve did not converge to finite values")
    check(res.primal.x.shape == (sp.np_pad, sp.n), "primal shape")
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")


def _timed_solver_for_mode(controller, setup):
    """Time each cached solver's setup (build_stacked + power iteration)
    as the closed loop first asks for it."""
    real = controller.solver_for_mode

    def timed(mode):
        if mode in setup:
            return real(mode)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = real(mode)
        out[0].operator_norm_sq()
        torch.cuda.synchronize()
        setup[mode] = time.perf_counter() - tic
        return out

    controller.solver_for_mode = timed


def phase_mpc_config5():
    """BASELINE config 5 at full size: two closed-loop steps."""
    tic = time.perf_counter()
    controller, x0 = network_mpc_controller(**CONFIG5, offline="device")
    setup = {}
    _timed_solver_for_mode(controller, setup)
    torch.cuda.reset_peak_memory_stats()
    with counted("mpc_config5_f32") as calls:
        run = controller.run(x0, num_steps=2, initial_mode=0, check_every=25,
                             unroll=5, chunk_iters=1250, max_iters=2500,
                             relax="auto")
    wall = time.perf_counter() - tic
    solver, problem = controller.solver_for_mode(int(run.modes[-2]))
    sp = solver.stacked
    tic = time.perf_counter()
    valid = solver.validate()
    validate_s = time.perf_counter() - tic
    plan = _plan_fields(sp)
    emit("mpc_config5_f32", nodes=sp.num_nodes, n=sp.n, m=sp.m,
         dtype=str(sp.dtype), steps=run.num_steps, modes=run.modes.tolist(),
         setup_s_per_solver={str(k): v for k, v in setup.items()},
         iterations=run.iterations.tolist(),
         solve_s=run.solve_times.tolist(),
         iters_per_second=(run.iterations / run.solve_times).tolist(),
         statuses=run.statuses.tolist(), total_cost=run.total_cost,
         wall_s=wall, max_memory_allocated_bytes=(
             torch.cuda.max_memory_allocated()),
         k1_launches=calls["k1"], prox_f_calls=calls["prox_f"],
         validate_last=valid, validate_s=validate_s,
         k1_fields=plan)
    check(sp.num_nodes == 88573 and sp.K is None,
          "config 5 is not the 88,573-node host-table tree")
    check(np.isfinite(run.states).all() and np.isfinite(run.inputs).all(),
          "closed-loop states or inputs not finite")
    check(run.states.shape == (3, 100) and run.inputs.shape == (2, 40),
          "closed-loop shapes")
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")


def _accel_window(phase, problem, x0, iters, **kw):
    """An accelerated solve capped at ``iters`` iterations, float64, on the
    card and on the CPU with one step size. The accelerators amplify
    rounding (one ulp on alpha moves the JAX package's own Anderson count
    on the demo from 353 to 418, tests/test_torch_accel.py), so the two are
    held together only inside a window where they still agree: the same
    T evaluations (every safeguard, line-search and fallback decision
    taken alike) and iterates within 1e-8. Returns both solvers and the
    solve options."""
    solvers = {"gpu": rt.Solver(problem, dtype=torch.float64, device=DEV),
               "cpu": rt.Solver(problem, dtype=torch.float64, device="cpu")}
    kw["alpha"] = 0.999 / solvers["cpu"].operator_norm_sq()
    res, calls = {}, {}
    for where, solver in solvers.items():
        with counted() as calls[where]:
            res[where] = solver.solve(x0, max_iters=iters, tol=1e-12, **kw)
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(res["gpu"].primal, res["cpu"].primal))
    evals = {w: c["prox_f"] for w, c in calls.items()}
    emit(phase, window_iters=iters, window_t_evals_gpu=evals["gpu"],
         window_t_evals_cpu=evals["cpu"],
         window_k1_launches_gpu=calls["gpu"]["k1"],
         window_max_iterate_diff=diff)
    check(evals["gpu"] == evals["cpu"] and diff <= 1e-8
          and res["gpu"].num_iters == res["cpu"].num_iters,
          f"{phase}: the first {iters} iterations differ between card and "
          f"CPU: {evals['gpu']} / {evals['cpu']} T evaluations, iterates "
          f"{diff} apart")
    return solvers, kw, calls["gpu"]


def phase_accel():
    """SuperMann on the headline (1,000 iterations at most); SuperMann on
    the uniform fixture (through K1) and Anderson on the demo, each in
    float64 on the card against the CPU port."""
    problem, x0 = random_network_problem(**HEADLINE)
    solver = rt.Solver(problem, device=DEV)
    solver.operator_norm_sq()
    reads = accel_mod.HOST_READS
    with counted("accel_headline_f32") as calls:
        res = solver.solve(x0, max_iters=1000, tol=1e-3, accel="supermann",
                           accel_memory=5, check_every=25)
    reads = accel_mod.HOST_READS - reads
    checked = res.xi_history[~np.isnan(res.xi_history).any(axis=1)]
    first = float(checked[0].max())
    emit("accel_headline_f32", accel="supermann", memory=5, check_every=25,
         iters=res.num_iters, t_evals=calls["prox_f"],
         k1_launches=calls["k1"], seconds=res.solve_time,
         iters_per_second=res.iters_per_second, xi=res.xi.tolist(),
         first_checked_xi=first, host_reads=reads,
         host_reads_per_iter=reads / res.num_iters)
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")
    check(np.isfinite(res.xi).all() and float(res.xi.max()) < first,
          f"SuperMann xi {res.xi} not below its first check {first}")

    # SuperMann on the uniform fixture runs K1 on the card. There one ulp
    # on alpha moves the CPU iterates by 2e-11 after 80 iterations and by
    # 9e-9 after 100, so its window is 80.
    problem, x0 = random_network_problem(**SMALL)
    _, _, calls = _accel_window("accel_supermann_small_window_f64", problem,
                                x0, 80, accel="supermann", accel_memory=5)
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"SuperMann window: K1 launches {calls['k1']} != prox_f calls "
          f"{calls['prox_f']}")

    # Anderson on the demo (ragged: no K1): its first 60 iterations, then
    # the converged counts on card and CPU are recorded
    problem, x0 = demo_problem()
    solvers, kw, _ = _accel_window("accel_anderson_demo_window_f64", problem,
                                   x0, 60, accel="anderson")
    gpu = solvers["gpu"].solve(x0, max_iters=2000, tol=1e-3, **kw)
    cpu = solvers["cpu"].solve(x0, max_iters=2000, tol=1e-3, **kw)
    valid = solvers["gpu"].validate(gpu)
    emit("accel_anderson_demo_f64", gpu_iters=gpu.num_iters,
         cpu_iters=cpu.num_iters, gpu_xi=gpu.xi.tolist(),
         cpu_xi=cpu.xi.tolist(), gpu_seconds=gpu.solve_time,
         gpu_validate=valid)
    check(gpu.converged and gpu.num_iters < 937,
          f"Anderson on the demo: {gpu.num_iters} iterations, status "
          f"{gpu.status}")
    check(max(valid.values()) < 1e-3,
          "Anderson's solution on the card fails validate")


def phase_batch_demo():
    """The demo's three lanes (tests/test_solver.py:330) in float64 on the
    card: a ragged tree, so the torch branches with a lane axis."""
    problem, x0 = demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, device=DEV)
    x0 = np.asarray(x0)
    res = solver.solve_batch(np.stack([x0, 0.5 * x0, -0.3 * x0]),
                             max_iters=2000, tol=1e-3)
    valid = [solver.validate(r) for r in res]
    emit("batch_demo_f64", iters=[r.num_iters for r in res],
         xi=[r.xi.tolist() for r in res], seconds=res[0].solve_time,
         validate=valid)
    check(res[0].num_iters == 937,
          f"the demo's lane 0 took {res[0].num_iters} iterations, not 937")
    check(all(r.converged for r in res)
          and max(max(v.values()) for v in valid) < 1e-8,
          "a demo lane did not converge to a valid solution")


def phase_batch_headline():
    """``solve_batch`` of the headline from bench_batch.py's eight initial
    states in float32, capped at 2,500 iterations, and a single card solve
    of lane 0's state in the same call."""
    problem, x0 = random_network_problem(**HEADLINE)
    solver = rt.Solver(problem)             # the default device: the card
    solver.operator_norm_sq()
    x0s = bench_lanes(x0)
    opts = dict(max_iters=2500, tol=1e-3, check_every=25, unroll=25)
    # K1's batched and unbatched calls are planned and packed on first use
    solver.solve_batch(x0s, max_iters=25, tol=1e-3)
    solver.solve(x0s[0], max_iters=25, tol=1e-3)
    torch.cuda.reset_peak_memory_stats()
    with counted("batch_headline_f32") as calls:
        res = solver.solve_batch(x0s, **opts)
    peak = torch.cuda.max_memory_allocated()
    single = solver.solve(x0s[0], **opts)
    sp = solver.stacked
    steps = max(r.num_iters for r in res)
    # lane 0 against the single solve: the checked rows of the first 200
    # iterations
    rows = ~np.isnan(single.xi_history[:200, 0])
    lane0, alone = res[0].xi_history[:200][rows], \
        single.xi_history[:200][rows]
    hist_rel = float(np.max(np.abs(lane0 - alone) / np.abs(alone)))
    emit("batch_headline_f32", nodes=sp.num_nodes, n=sp.n, m=sp.m,
         dtype=str(sp.dtype), lanes=len(res),
         tree_rows_per_k1_apply=len(res) * sp.num_nodes,
         iters=[r.num_iters for r in res], solve_s=res[0].solve_time,
         step_ms=1e3 * res[0].solve_time / steps,
         batch_iters_per_second=steps / res[0].solve_time,
         lane_iters_per_second=sum(r.num_iters for r in res)
         / res[0].solve_time,
         single_iters=single.num_iters, single_solve_s=single.solve_time,
         single_iters_per_second=single.iters_per_second,
         xi=[r.xi.tolist() for r in res],
         lane0_vs_single_max_rel=hist_rel, k1_launches=calls["k1"],
         prox_f_calls=calls["prox_f"], max_memory_allocated_bytes=peak)
    check(all(np.isfinite(v).all() for r in res for v in r.primal)
          and all(np.isfinite(r.xi).all() for r in res),
          "a headline lane is not finite")
    check(all(r.primal.x.shape == (sp.np_pad, sp.n) for r in res),
          "a lane's primal shape")
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}: "
          "not one launch set per batched apply")
    check(rows.sum() >= 8 and hist_rel <= 1e-3,
          f"lane 0's first 200 iterations differ from the single solve's "
          f"by {hist_rel} (relative)")


def baseline_batch(names=("batch_config4_f32", "batch_config4_f64",
                          "batch_config3_f32")):
    """``scripts/bench_batch.py``'s two measurements on the card: eight
    lanes solved to 1e-3 in one batch against eight sequential solves, at
    the headline (BASELINE config 4, in float32 and in float64) and at
    config 3 (``soc_network_problem()``, ``offline="device"``, float32).
    Each lane must end as its sequential solve does (converged, or at the
    cap). In float64 its count must be within one check period (25) of
    its sequential count, ``scripts/bench_batch.py``'s check. In float32 a
    lane rounds otherwise than its single solve (other tiles of K1, other
    GEMM shapes), and where a residual lingers near the tolerance that
    moves its first check below it: there a lane's count must be within
    ``F32_COUNT_SLACK`` of its sequential count (PERF.md: a config-4 lane
    625 iterations, 5.3%, from its count in two float32 runs, and every
    lane within 25 in float64)."""
    configs = {
        "batch_config4_f32": (lambda: random_network_problem(**HEADLINE),
                              torch.float32, 20000, {}),
        "batch_config4_f64": (lambda: random_network_problem(**HEADLINE),
                              torch.float64, 20000, {}),
        "batch_config3_f32": (soc_network_problem, torch.float32, 4000,
                              dict(offline="device"))}
    for name in names:
        make, dtype, max_iters, extra = configs[name]
        problem, x0 = make()
        solver = rt.Solver(problem, dtype=dtype, device=DEV, **extra)
        solver.operator_norm_sq()
        x0s = bench_lanes(x0)
        kw = dict(max_iters=max_iters, tol=1e-3, check_every=25, unroll=25)
        solver.solve(x0s[0], max_iters=25, tol=1e-3)      # warm up
        solver.solve_batch(x0s, max_iters=25, tol=1e-3)
        tic = time.perf_counter()
        seq = [solver.solve(x, **kw) for x in x0s]
        seq_s = time.perf_counter() - tic
        with counted(name) as calls:
            tic = time.perf_counter()
            bat = solver.solve_batch(x0s, **kw)
            bat_s = time.perf_counter() - tic
        diff = [b.num_iters - a.num_iters for a, b in zip(seq, bat)]
        slack = [25 if dtype == torch.float64
                 else max(25, F32_COUNT_SLACK * a.num_iters) for a in seq]
        emit(name, nodes=solver.stacked.num_nodes, dtype=str(dtype),
             lanes=len(bat), sequential_s=seq_s, batched_s=bat_s,
             ratio=seq_s / bat_s,
             sequential_iters=[r.num_iters for r in seq],
             batched_iters=[r.num_iters for r in bat],
             sequential_status=[r.status for r in seq],
             batched_status=[r.status for r in bat], count_diff=diff,
             count_slack=slack,
             lanes_beyond_one_period=sum(abs(d) > 25 for d in diff),
             sequential_lane_iters_per_second=sum(
                 r.num_iters for r in seq) / seq_s,
             batched_lane_iters_per_second=sum(
                 r.num_iters for r in bat) / bat_s,
             k1_launches=calls["k1"], prox_f_calls=calls["prox_f"])
        check([r.status for r in seq] == [r.status for r in bat],
              f"{name}: a lane ends otherwise than its sequential solve")
        check(all(abs(d) <= s for d, s in zip(diff, slack)),
              f"{name}: a lane's count is further from its sequential "
              f"count than {slack}: {diff}")
        check(not sweep.sweep_eligible(solver.stacked)
              or calls["k1"] == calls["prox_f"] > 0,
              f"{name}: K1 launches {calls['k1']} != prox_f calls "
              f"{calls['prox_f']}")


def baseline(config5_steps):
    """BASELINE config 4 (SuperMann) and config 5 (closed loop) to 1e-3,
    as ``scripts/bench_configs.py`` runs them in the JAX package."""
    problem, x0 = random_network_problem(**HEADLINE)
    tic = time.perf_counter()
    solver = rt.Solver(problem, device=DEV)
    solver.operator_norm_sq()
    setup_s = time.perf_counter() - tic
    with counted("config4_supermann") as calls:
        res = solver.solve(x0, max_iters=20000, tol=1e-3, accel="supermann")
    emit("config4_supermann_f32", nodes=solver.stacked.num_nodes,
         converged=res.converged, iters=res.num_iters,
         t_evals=calls["prox_f"], k1_launches=calls["k1"],
         time_to_tol_s=res.solve_time, setup_s=setup_s,
         iters_per_second=res.iters_per_second, xi=res.xi.tolist(),
         max_violation=max(solver.validate(res).values()))
    check(res.converged, "config 4 SuperMann did not converge")

    controller, x0 = network_mpc_controller(**CONFIG5, offline="device",
                                            device=DEV)
    setup = {}
    _timed_solver_for_mode(controller, setup)
    tic = time.perf_counter()
    with counted("config5_closed_loop") as calls:
        run = controller.run(x0, num_steps=config5_steps, max_iters=20000,
                             tol=1e-3, check_every=25, unroll=5,
                             chunk_iters=2500, relax="auto")
    emit("config5_closed_loop_f32", steps=run.num_steps,
         converged=run.converged, modes=run.modes.tolist(),
         iterations=run.iterations.tolist(),
         solve_s=run.solve_times.tolist(),
         setup_s_per_solver={str(k): v for k, v in setup.items()},
         wall_s=time.perf_counter() - tic, k1_launches=calls["k1"],
         prox_f_calls=calls["prox_f"], total_cost=run.total_cost)
    check(run.converged, "a config-5 step did not converge")


def profile_config5(steps=100):
    """Where a CP step of config 5 (88,573 nodes, float32) goes, from the
    trace that ``solve(profile_dir=...)`` writes: the wall time per step
    (from the first device event's start to the last one's end), the share
    of it the card is busy, K1's share of the card's time, and the kernels
    that take most of it."""
    controller, x0 = network_mpc_controller(**CONFIG5, offline="device")
    solver, _ = controller.solver_for_mode(0)
    solver.operator_norm_sq()
    opts = dict(max_iters=steps, tol=1e-12, check_every=25, unroll=5,
                relax="auto")
    solver.solve(x0, **opts)                    # warm up, builds K1
    with tempfile.TemporaryDirectory() as folder, counted() as calls:
        res = solver.solve(x0, profile_dir=folder, **opts)
        with open(os.path.join(folder, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
    events = [ev for ev in events
              if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(events, "the trace holds no device event")
    by_name = {}                                # kernel -> [us, launches]
    for ev in events:
        entry = by_name.setdefault(ev["name"], [0.0, 0])
        entry[0] += ev["dur"]
        entry[1] += 1
    busy_us = sum(t for t, _ in by_name.values())
    wall_us = max(ev["ts"] + ev["dur"] for ev in events) \
        - min(ev["ts"] for ev in events)
    k1_us = sum(t for name, (t, _) in by_name.items()
                if "stage_kernel" in name or "apex_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    emit("profile_config5_f32", nodes=solver.stacked.num_nodes,
         steps=res.num_iters,
         wall_ms_per_step=1e-3 * wall_us / res.num_iters,
         device_ms_per_step=1e-3 * busy_us / res.num_iters,
         device_busy_share=busy_us / wall_us,
         k1_ms_per_step=1e-3 * k1_us / res.num_iters,
         k1_share_of_device=k1_us / busy_us, k1_launches=calls["k1"],
         kernel_launches_per_step=sum(
             c for _, c in by_name.values()) / res.num_iters,
         top_kernels=[dict(name=name[:60], ms_per_step=1e-3 * t
                           / res.num_iters, launches_per_step=c
                           / res.num_iters) for name, (t, c) in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="store_true",
                    help="run BASELINE configs 3-5 to 1e-3 instead")
    ap.add_argument("--config5-steps", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="profile 100 CP steps of config 5 instead")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    if args.baseline or args.profile:
        if args.profile:
            profile_config5()
        else:
            baseline(args.config5_steps)
            baseline_batch()
        print(smi, flush=True)
        return 0
    kernel = phase_kernel()
    phase_matmul_context()
    demo = phase_parity()
    phase_chunked(demo)
    phase_headline()
    phase_mpc_config5()
    phase_accel()
    phase_batch_demo()
    phase_batch_headline()
    # the kernel's own numbers are the headline's (the first K1 path); every
    # timed shape stands beside it, config 5's full size included
    c = kernel["c_headline_f32"]
    worst = max(kernel.values(), key=lambda r: r["rel_err"])
    shape_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "lanes", "launches_per_apply", "flop",
                  "bytes", "ms_over_bound")
    print(json.dumps({"kernels": [{
        "name": "K1 dynamics-projection sweep",
        "route": "cuda",
        "source": "raocp_tpu_torch/csrc/sweep.cu",
        "replaces": "raocp_tpu/ops/pallas_sweep.py:79",
        "launches": sum(PATH_LAUNCHES.values()),
        "launches_per_path": PATH_LAUNCHES,
        "max_abs_err": max(r["max_abs_err"] for r in kernel.values()),
        "max_rel_err": worst["rel_err"],
        "max_rel_err_case": worst["case"],
        **{k: c[k] for k in shape_keys},
        "library_note": "no single PyTorch call computes the sweep",
        "per_shape": {name: {k: r[k] for k in shape_keys}
                      for name, r in kernel.items()}}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
