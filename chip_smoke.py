"""Smoke run of raocp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel (K1, the dynamics-projection sweep) from
``raocp_tpu_torch/csrc``, holds it against its plain torch version on the
card, checks the solver's iteration-count parity on the card, and drives the
main path once, ``Solver(problem, device="cuda").solve(x0)``, at the
50-state, 20-input, 3-mode, 8-stage (9,841-node) configuration in float32.
It prints one JSON line per phase, the kernel table, the card's name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises; without a CUDA device it fails before printing anything. It imports
no JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.models import (demo_problem,  # noqa: E402
                                    random_network_problem)
from raocp_tpu_torch.ops import sweep  # noqa: E402

DEV = torch.device("cuda", 0)
SMALL = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
             stopping_time=4)
HEADLINE = dict(num_states=50, num_inputs=20, num_modes=3, num_stages=8,
                stopping_time=8)
# the JAX package's float32 count on this problem (BENCH_configs_r05.jsonl,
# config 4): context only, not asserted
JAX_F32_ITERS = 10174


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


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


def _sweep_inputs(kwargs, dtype, pad):
    spec, x0 = random_network_problem(**kwargs)
    sp = build_stacked(spec, dtype=dtype, pad_multiple=pad, device=DEV)
    rng = np.random.default_rng(0)
    x_in = torch.as_tensor(rng.standard_normal((sp.np_pad, sp.n)),
                           dtype=dtype, device=DEV)
    u_in = torch.as_tensor(rng.standard_normal((sp.nl_pad, sp.m)),
                           dtype=dtype, device=DEV)
    return sp, x_in, u_in, torch.as_tensor(x0, dtype=dtype, device=DEV)


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


def phase_kernel():
    """K1 against its plain version on the card. The error is relative to
    the output's inf-norm; ghost rows must be exactly zero."""
    cases = (("a_small_f64", SMALL, torch.float64, 4, 1e-12),
             ("b_small_f32", SMALL, torch.float32, 4, 1e-5),
             # 8 sequential stages of up to c*n+m = 170-term float32 sums,
             # summed in another order than cuBLAS's
             ("c_headline_f32", HEADLINE, torch.float32, 8, 1e-4))
    out = {}
    for name, kwargs, dtype, pad, tol in cases:
        sp, x_in, u_in, x0 = _sweep_inputs(kwargs, dtype, pad)
        check(sweep.sweep_eligible(sp), f"{name}: not sweep-eligible")
        x, u = sweep.project_dynamics_sweep(sp, x_in, u_in, x0)
        torch.cuda.synchronize()
        x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, x_in, u_in, x0)
        err = max(float((x - x_ref).abs().max()),
                  float((u - u_ref).abs().max()))
        scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
        ghosts_zero = bool(torch.all(x[sp.num_nodes:] == 0)
                           and torch.all(u[sp.num_nonleaf:] == 0))
        finite = bool(torch.isfinite(x).all() and torch.isfinite(u).all())
        row = dict(case=name, nodes=sp.num_nodes, n=sp.n, m=sp.m,
                   dtype=str(dtype), max_abs_err=err, ref_inf_norm=scale,
                   rel_err=err / scale, tol=tol, ghost_rows_zero=ghosts_zero)
        if name.startswith("c_"):
            row["kernel_ms"] = _median_ms(
                lambda: sweep.project_dynamics_sweep(sp, x_in, u_in, x0))
            row["plain_ms"] = _median_ms(
                lambda: sweep.project_dynamics_sweep_ref(sp, x_in, u_in, x0))
            row["kernel_us_per_apply"] = 1e3 * row["kernel_ms"]
            row["plain_us_per_apply"] = 1e3 * row["plain_ms"]
        emit("kernel_vs_plain", **row)
        check(finite and err <= tol * scale,
              f"K1 {name}: error {err} above {tol} x {scale}")
        check(ghosts_zero, f"K1 {name}: ghost rows not zero")
        out[name] = row
    return out


def phase_parity():
    # the demo (a ragged tree: the torch branches) on the card, float64
    problem, x0 = demo_problem()
    res = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
        x0, max_iters=2000, tol=1e-3)
    emit("parity_demo_f64", iters=res.num_iters, xi=res.xi.tolist())
    check(res.converged and res.num_iters == 937,
          f"demo took {res.num_iters} iterations, not 937")
    check(np.allclose(res.xi, [9.9508e-4, 9.4106e-4, 9.5599e-4], rtol=1e-3,
                      atol=0), f"demo xi {res.xi}")
    # the uniform fixture: K1 on the card against the plain version on CPU
    problem, x0 = random_network_problem(**SMALL)
    before = sweep.LAUNCHES
    gpu = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
        x0, max_iters=20000, tol=1e-3)
    launched = sweep.LAUNCHES - before
    cpu = rt.Solver(problem, dtype=torch.float64, device="cpu").solve(
        x0, max_iters=20000, tol=1e-3)
    emit("parity_small_f64", gpu_iters=gpu.num_iters,
         cpu_iters=cpu.num_iters, gpu_objective=gpu.objective,
         cpu_objective=cpu.objective, k1_launches=launched)
    check(gpu.converged and gpu.num_iters == cpu.num_iters,
          "CUDA and CPU iteration counts differ")
    check(abs(gpu.objective - cpu.objective) <= 1e-9,
          "CUDA and CPU objectives differ")
    check(launched == gpu.num_iters, "K1 not launched once per CP step")


def phase_headline():
    problem, x0 = random_network_problem(**HEADLINE)
    calls = {"prox_f": 0}
    real_prox_f = solver_mod.prox_f

    def counting_prox_f(*args, **kwargs):
        calls["prox_f"] += 1
        return real_prox_f(*args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sweep.LAUNCHES = 0
    solver_mod.prox_f = counting_prox_f
    try:
        tic = time.perf_counter()
        solver = rt.Solver(problem, device=DEV)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - tic
        tic = time.perf_counter()
        solver.operator_norm_sq()
        power_s = time.perf_counter() - tic
        res = solver.solve(x0, max_iters=20000, tol=1e-3, check_every=25)
    finally:
        solver_mod.prox_f = real_prox_f
    launches = sweep.LAUNCHES
    sp = solver.stacked
    finite = all(np.isfinite(v).all() for v in res.primal)
    emit("headline_f32", nodes=sp.num_nodes, n=sp.n, m=sp.m,
         dtype=str(sp.dtype), build_stacked_s=build_s,
         power_iteration_s=power_s,
         power_iterations=solver.power_iterations, cp_iters=res.num_iters,
         jax_f32_iters_for_context=JAX_F32_ITERS, solve_s=res.solve_time,
         iters_per_second=res.iters_per_second, xi=res.xi.tolist(),
         objective=res.objective, k1_launches=launches,
         prox_f_calls=calls["prox_f"],
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    check(res.converged and np.isfinite(res.xi).all() and finite,
          "headline solve did not converge to finite values")
    check(res.primal.x.shape == (sp.np_pad, sp.n), "primal shape")
    check(launches > 0 and launches == calls["prox_f"],
          f"K1 launches {launches} != prox_f calls {calls['prox_f']}")
    return launches


def main():
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    phase_parity()
    launches = phase_headline()
    c = kernel["c_headline_f32"]
    print(json.dumps({"kernels": [{
        "name": "K1 dynamics-projection sweep",
        "route": "cuda",
        "source": "raocp_tpu_torch/csrc/sweep.cu",
        "replaces": "raocp_tpu/ops/pallas_sweep.py:79",
        "launches": launches,
        "max_abs_err": c["max_abs_err"],
        "ms": c["kernel_ms"],
        "plain_ms": c["plain_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
