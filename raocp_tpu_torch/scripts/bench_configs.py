"""Run the five BASELINE.json configurations end to end on the port
(counterpart of the JAX package's ``scripts/bench_configs.py``).

    python -m raocp_tpu_torch.scripts.bench_configs [--configs 1,2,3,4,5]
        [--dtype float32|float64] [--device cpu]

For each of configs 1-4: build the problem, solve to 1e-3 (the BASELINE
target residual) twice with the JAX script's options and time the second
solve (the first pays K1's per-problem packing), validate it, and print
one JSON line with the JAX script's fields, the dtype, the K1 launches and
``prox_f`` calls of the timed solve, and the JAX package's float64 count
for the same row and options (``jax_reference.json``) beside the port's.
Config 4 adds a SuperMann row. Config 5 is the closed-loop risk-averse MPC
run: five steps on the 100-state plant, an 88,573-node tree a step; its
row carries the JAX package's realised modes and, as context from a TPU
in float32, its per-step counts.

  1. 2-state/1-input LQR-style RAOCP, binary tree, N=3, AVaR
  2. mass-spring chain (10 states), branching-2, horizon 6, input boxes
  3. 20-state, branching-3, horizon 7 (3,280 nodes), SOC (ball) + AVaR
  4. 50-state network, 9,841-node tree, plain CP and SuperMann
  5. 100-state, 88,573-node tree, closed-loop risk-averse MPC

It runs on the card unless ``--device cpu`` is given, and a row that
raises fails the run.
"""

import argparse
import contextlib
import dataclasses
import functools
import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from raocp_tpu_torch import models
from raocp_tpu_torch import solver as solver_mod
from raocp_tpu_torch.core.stacked import _torch_dtype, default_dtype
from raocp_tpu_torch.ops import sweep

__all__ = ["CONFIGS", "CONFIG5", "CONFIG5_RUN", "SOLVE", "STRIDED", "Config",
           "card", "counted_calls", "device_fields", "jax_reference",
           "peak_mb", "reference_row", "reset_peak", "run_config", "sync",
           "keyed_rows", "timed_solves"]


@dataclasses.dataclass(frozen=True)
class Config:
    """One of configs 1-4: the problem family and its arguments, the
    Solver's and the solve's options, and the accelerated row, if any."""

    name: str
    family: str
    problem: dict
    offline: str
    solve: dict
    accel: Optional[str] = None

    def make(self, family_module=models):
        """(problem, x0) from ``family_module`` (the port's models; the
        JAX package's for its reference)."""
        return getattr(family_module, self.family)(**self.problem)


# every row solves to the BASELINE tolerance with these, plus its own
SOLVE = dict(max_iters=20000, tol=1e-3)
CONFIGS = {
    1: Config("1_lqr_binary_15node", "lqr_binary_problem",
              dict(num_stages=3), "host", {}),
    2: Config("2_mass_spring_127node", "mass_spring_problem",
              dict(num_masses=5, num_stages=6), "host", {}),
    3: Config("3_soc_network_3k_node", "soc_network_problem",
              dict(num_states=20, num_inputs=8, num_modes=3, num_stages=7,
                   stopping_time=7), "device", dict(chunk_iters=2500)),
    4: Config("4_network_1e4", "random_network_problem",
              dict(num_states=50, num_inputs=20, num_modes=3, num_stages=8,
                   stopping_time=8), "device", dict(chunk_iters=2500),
              accel="supermann"),
}
# config 5: the per-step problem is the fully branched 88,573-node tree
# (3^0..3^10); the production loop's options (check_every=25, unroll=5),
# each device execution bounded by chunk_iters
CONFIG5 = dict(num_states=100, num_inputs=40, num_modes=3, num_stages=10,
               stopping_time=10)
CONFIG5_RUN = dict(num_steps=5, max_iters=20000, tol=1e-3, check_every=25,
                   unroll=5, chunk_iters=2500, relax="auto")
# the production loop's stride: the smoke solves config 3 at it (a card step
# at check_every=1 is bound by the host's read of the residuals), and the
# reference holds config 3 at it too
STRIDED = dict(check_every=25, unroll=25)
_REFERENCE = Path(__file__).resolve().parent / "jax_reference.json"


@functools.lru_cache(maxsize=1)
def jax_reference() -> dict:
    """The JAX package's committed results (``jax_reference.json``)."""
    with open(_REFERENCE) as fh:
        return json.load(fh)


def reference_row(name: str, solve: dict) -> Optional[dict]:
    """The JAX package's float64 row of ``name`` solved with the options
    ``solve`` (the row's own, :data:`SOLVE` included; for the sweeps'
    rows also the stacking's ``offline``), or None where the reference
    holds no such row."""
    ref = jax_reference()
    for row in ref["rows"] + ref.get("sweeps", {}).get("rows", []):
        if row["config"] == name and row["solve"] == solve:
            return row
    return None


@contextlib.contextmanager
def counted_calls():
    """Count the K1 launches and the ``prox_f`` calls (the T evaluations
    of a CP step, accelerated or not) that ran on the device while the body
    runs; the counts are read after it. A call made while a CUDA graph is
    captured runs nothing and is not counted; the device loop's replays
    add the calls and launches they ran (``solver.LOOP_COUNTS``,
    ``ops.sweep.LAUNCHES``). Nothing is reset, so an outer count goes on
    counting."""
    calls = {"prox_f": 0, "k1": 0}
    real = solver_mod.prox_f
    graphs = torch.cuda.is_available()

    def counting(*args, **kwargs):
        if not (graphs and torch.cuda.is_current_stream_capturing()):
            calls["prox_f"] += 1
        return real(*args, **kwargs)

    before = sweep.LAUNCHES
    replayed = solver_mod.LOOP_COUNTS["replayed_steps"]
    solver_mod.prox_f = counting
    try:
        yield calls
    finally:
        solver_mod.prox_f = real
        calls["k1"] = sweep.LAUNCHES - before
        calls["prox_f"] += solver_mod.LOOP_COUNTS["replayed_steps"] - replayed


def sync(device):
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def card(device) -> Optional[str]:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them (a
    card below its 700 W limit runs slower under load), or None off a
    card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def reset_peak(device):
    """Start a peak-memory reading of the card (none on the CPU)."""
    if torch.device(device).type == "cuda":
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_mb(device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in MB since :func:`reset_peak`
    (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def device_fields(solver_or_sp) -> dict:
    """What every runner's row says of where it ran: the dtype, the device,
    the card's ``name, power.limit``, and whether K1 is on the problem's
    path (``k1_path``: every ``prox_f`` call then launches it once on a
    card)."""
    sp = getattr(solver_or_sp, "stacked", solver_or_sp)
    return dict(dtype=str(sp.dtype), device=str(sp.device),
                card=card(sp.device), k1_path=sweep.sweep_eligible(sp))


def timed_solves(solver, x0, repeats: int, **solve):
    """``solver.solve(x0, **solve)`` ``repeats`` times, after one solve of
    25 iterations that pays K1's per-problem packing and the allocator's
    growth (the port compiles nothing per call, so a full solve is not
    needed to warm it). Returns the last result, the best wall seconds and
    the last solve's counts (:func:`counted_calls`)."""
    solver.solve(x0, **{**solve, "max_iters": 25})
    best = float("inf")
    for _ in range(repeats):
        with counted_calls() as calls:
            res = solver.solve(x0, **solve)
        best = min(best, res.solve_time)
    return res, best, calls


def keyed_rows(cfg: Config, keys: dict, dtype, device, repeats: int):
    """Config ``cfg`` solved with each of ``keys`` (label -> key: the
    stacking's ``offline``, one for all, and the solve's options, as
    ``jax_reference.json`` keys its rows) on one Solver, each timed by
    :func:`timed_solves`. Yields (label, the fields every such row has,
    the JAX package's row for the key or {})."""
    problem, x0 = cfg.make()
    (offline,) = {key["offline"] for key in keys.values()}
    solver = solver_mod.Solver(problem, dtype=dtype, offline=offline,
                               device=device)
    for label, key in keys.items():
        solve = {o: v for o, v in key.items() if o != "offline"}
        reset_peak(device)
        res, best, calls = timed_solves(solver, x0, repeats, **solve)
        ref = reference_row(cfg.name, key) or {}
        yield label, dict(
            config=cfg.name, num_nodes=problem.tree.num_nodes,
            iterations=res.num_iters,
            converged=bool(np.max(res.xi) <= solve["tol"]),
            time_to_tol_s=best, iters_per_s=res.num_iters / best,
            **device_fields(solver), k1_launches=calls["k1"],
            prox_f_calls=calls["prox_f"],
            max_memory_allocated_mb=peak_mb(device),
            jax_iterations=ref.get("iterations"), xi=res.xi.tolist(),
            alpha=res.alpha, solve=key), ref


def _solve_rows(cfg: Config, dtype, device, repeats: int, options: dict):
    """The plain row of ``cfg`` (and its accelerated row), each solved
    ``repeats`` times, the last solve timed and counted."""
    problem, x0 = cfg.make()
    sync(device)
    tic = time.perf_counter()
    solver = solver_mod.Solver(problem, dtype=dtype, offline=cfg.offline,
                               device=device)
    solver.operator_norm_sq()
    sync(device)
    setup_s = time.perf_counter() - tic
    runs = [(cfg.name, {**SOLVE, **cfg.solve, **options})]
    if cfg.accel is not None:
        # the accelerated loops carry their own histories and do not chunk
        runs.append((f"{cfg.name}_{cfg.accel}",
                     {**SOLVE, **options, "accel": cfg.accel}))
    rows = []
    for name, solve in runs:
        for _ in range(repeats - 1):
            solver.solve(x0, **solve)
        with counted_calls() as calls:
            res = solver.solve(x0, **solve)
        ref = reference_row(name, solve) or {}
        checked = res.xi_history[~np.isnan(res.xi_history).any(axis=1)]
        rows.append(dict(
            config=name, num_nodes=problem.tree.num_nodes,
            converged=res.converged, iterations=res.num_iters,
            iters_per_s=res.iters_per_second, time_to_tol_s=res.solve_time,
            setup_s=setup_s,
            max_violation=max(solver.validate(res).values()),
            accel=solve.get("accel"), dtype=str(solver.stacked.dtype),
            k1_launches=calls["k1"], prox_f_calls=calls["prox_f"],
            jax_iterations=ref.get("iterations"),
            objective=res.objective, jax_objective=ref.get("objective"),
            xi=res.xi.tolist(), xi_last_two_checks=checked[-2:].tolist(),
            alpha=res.alpha, solve=solve))
    return rows


def _closed_loop_row(dtype, device, options: dict):
    """Config 5: the closed loop of ``CONFIG5_RUN`` (with ``options``)."""
    run_kw = {**CONFIG5_RUN, **options}
    controller, x0 = models.network_mpc_controller(
        **CONFIG5, dtype=dtype, offline="device", device=device)
    tic = time.perf_counter()
    with counted_calls() as calls:
        run = controller.run(x0, **run_kw)
    wall = time.perf_counter() - tic
    solver = controller.solver_for_mode(int(run.modes[0]))[0]
    ref = jax_reference()["config5"]
    return dict(
        config="5_mpc_closed_loop_1e5",
        num_nodes=solver.stacked.num_nodes, converged=run.converged,
        mpc_steps=run.num_steps,
        iterations_per_step=run.iterations.tolist(), wall_s=wall,
        relax=solver_mod._resolve_relax(run_kw["relax"]),
        relax_mode="auto" if run_kw["relax"] == "auto" else "explicit",
        dtype=str(solver.stacked.dtype), k1_launches=calls["k1"],
        prox_f_calls=calls["prox_f"], modes=run.modes.tolist(),
        jax_modes=ref["modes"][:run.num_steps + 1],
        total_cost=run.total_cost, solve_s=run.solve_times.tolist(),
        jax_tpu_f32_iterations_per_step=ref["tpu_f32_iterations_per_step"],
        run=run_kw)


def run_config(k: int, dtype=None, device="cuda", repeats: int = 2,
               **options) -> list:
    """BASELINE config ``k`` (1-5) on ``device`` in ``dtype`` (the device's
    default: float32 on a GPU, float64 on the CPU); returns its rows.

    ``options`` override the config's solve options (configs 1-4: e.g.
    ``check_every``, ``unroll``, ``max_iters``) or its closed-loop options
    (config 5: e.g. ``num_steps``). Configs 1-4 solve each row
    ``repeats`` times and time and count the last solve."""
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    if k == 5:
        return [_closed_loop_row(dtype, device, options)]
    if k not in CONFIGS:
        raise ValueError(f"no BASELINE config {k} (1-5)")
    return _solve_rows(CONFIGS[k], dtype, device, repeats, options)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    help="default: float32 on the card, float64 on the CPU")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    for k in (int(c) for c in args.configs.split(",")):
        for row in run_config(k, dtype=dtype, device=args.device):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
