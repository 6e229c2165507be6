"""Smoke run of raocp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # the smoke run (about 8 minutes)
    python3 chip_smoke.py --baseline    # BASELINE configs 3-5 to 1e-3
    python3 chip_smoke.py --profile     # where a config-5 CP step's time goes
    python3 chip_smoke.py --mesh        # the partitioned phases alone
                                        # (subtree and flat)

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
  single solve's;
* ``mesh_demo_f64`` and ``mesh_config5_f32``: the subtree partition
  (``Solver(mesh=...)``) over two gloo ranks that share the card (NCCL
  refuses two ranks on one device). The script starts itself twice as the
  ranks (``--rank r --world 2 --port p``); each places itself on card
  ``rank % device_count``, runs the demo in float64 with the default options
  (937 iterations) and one closed-loop step of BASELINE config 5 at full
  size (88,573 nodes) capped at 250 iterations, and writes what it got; the
  script holds the ranks against each other and against single-card runs
  of the same (made here, before the ranks start): the demo's iterates to
  1e-12, config 5's within three times the single card's own float32
  rounding (its distance to the same step in float64). A rank that fails,
  or a group that times out, fails the run. The partitioned sweep runs the torch
  stage path with the frontier all-reduce, as the JAX package's partition
  does (no Pallas kernel there): 0 K1 launches;
* ``mesh_flat_demo_f64`` and ``mesh_flat_headline_f64``: the flat node
  partition (``partition="flat"``) in the same two ranks, after the subtree
  phases: the demo in float64 (937 iterations, iterates within 1e-12 of the
  single card's), the ragged 3-stage demo under "auto" (flat), three lanes
  in one ``solve_batch`` (lane 0: 937) and an Anderson window against the
  single card; then BASELINE config 4 at full width (9,841 nodes, not cut)
  in float64, plain CP capped at 500 iterations and SuperMann at 100, each
  at the single card's step size and held against the same runs on the
  single card (K1 there; iterates and histories within 1e-9 relative).
  Each prints its ms a step beside the single card's, its exchanges and
  all-reduces a step, the bytes a rank sends, the host ms in them with the
  wait for the stream apart, and each rank's peak memory. The flat sweep
  runs the torch stage path with its halo exchanges: 0 K1 launches.

It prints one JSON line per phase, the kernel table, the card's name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises; without a CUDA device it fails before printing anything. It imports
no JAX. ``--baseline`` runs, instead of the smoke phases, the BASELINE
config-4 SuperMann solve and the config-5 closed loop to tolerance 1e-3
(``--config5-steps``, default 1), and ``scripts/bench_batch.py``'s two
measurements on the card: eight lanes of the headline (in float32 and in
float64) and of ``soc_network_problem()`` with its defaults (the SOC
network, 148 nodes; not BASELINE config 3's 3,280) to 1e-3 in one batch
against eight sequential solves. ``--profile`` runs 100 CP steps of
config 5 with ``solve(profile_dir=...)`` and prints, from that trace, the
card's busy share of the step and its kernels by time.
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
# config 5's partitioned float32 step against the single card's, on each
# iterate leaf relative to that leaf's inf-norm: within this many times the
# single card's own float32 rounding of the leaf (its distance to the same
# step in float64), plus 1e-6. After 500 unconverged steps (the cap until
# the flat phases joined the run) the leaf SOC duals e11-e13 carried 7-10%
# of float32 rounding on either layout, the other leaves at most 1.3e-4;
# the partition's gap measured 0.53-1.5 times the single card's own
# (PERF.md, the partition's findings)
MESH_CONFIG5_ROUNDING = 3.0
# and the applied input, relative to its largest entry (measured 1.6e-4
# after 500 steps)
MESH_CONFIG5_INPUT_TOL = 1e-3


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


# -- the partitions over two gloo ranks on the card -------------------------

MESH_WORLD = 2
# every collective's bound (seconds) inside the ranks, and the ranks' whole
# run's bound
MESH_GROUP_TIMEOUT = 120
MESH_TIMEOUT = 900
# BASELINE config 5's partitioned step: the closed loop's options, capped
# (at 250 iterations, from 500, to keep the smoke near 8 minutes with the
# flat phases)
MESH_CONFIG5_RUN = dict(num_steps=1, initial_mode=0, max_iters=250,
                        check_every=25, unroll=5, relax="auto")
# the flat partition's runs: the demo with its default options (and its
# three lanes, an Anderson window, the ragged tree with no subtree
# frontier); the headline's plain CP and SuperMann, capped
FLAT_DEMO = dict(max_iters=2000, tol=1e-3)
FLAT_BATCH_SCALES = (1.0, 0.5, -0.3)
FLAT_ANDERSON_WINDOW = 60
RAGGED = dict(num_stages=3, stopping_time=3)
FLAT_HEADLINE_CP = dict(max_iters=500, tol=1e-3, check_every=25, unroll=25)
FLAT_HEADLINE_SUPERMANN = dict(max_iters=100, tol=1e-3, accel="supermann",
                               accel_memory=5)
# the flat headline against the single card in float64: K1 against the
# torch sweep and other summation orders alone, so every iterate leaf
# within this much of its inf-norm, the histories of their largest entry.
# A leaf below FLAT_NOISE_FLOOR of the iterate's largest entry holds
# rounding noise alone (SuperMann's e7 on the headline: 5e-18 against 11,
# its constraints far from binding), so it is measured against that floor
FLAT_HEADLINE_REL = 1e-9
FLAT_NOISE_FLOOR = 1e-6


@contextlib.contextmanager
def _t_evals():
    """Count ``prox_f`` calls (the T evaluations) while a solve runs,
    leaving the K1 launch count alone."""
    calls = {"prox_f": 0}
    real = solver_mod.prox_f

    def counting(*args, **kwargs):
        calls["prox_f"] += 1
        return real(*args, **kwargs)

    solver_mod.prox_f = counting
    try:
        yield calls
    finally:
        solver_mod.prox_f = real


def _mesh_counters():
    from raocp_tpu_torch.parallel import sharding
    torch.cuda.synchronize()
    sharding.reset_counters()
    sweep.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()


def _collective_read(iters):
    """What a rank's run exchanged, per CP step (per iteration of an
    accelerated run): all-reduces and halo exchanges, the bytes in them
    (an exchange: what this rank sends), the host ms in the collectives and,
    apart, in the wait for the rank's own stream before each; K1 launches
    and peak memory."""
    from raocp_tpu_torch.parallel import sharding as sh
    torch.cuda.synchronize()
    return dict(
        all_reduces=sh.ALL_REDUCES,
        all_reduces_per_step=sh.ALL_REDUCES / iters,
        all_reduce_bytes_per_step=sh.ALL_REDUCE_BYTES / iters,
        all_reduce_ms_per_step=1e3 * sh.ALL_REDUCE_SECONDS / iters,
        all_reduce_wait_ms_per_step=1e3 * sh.ALL_REDUCE_WAIT_SECONDS / iters,
        exchanges=sh.EXCHANGES,
        exchanges_per_step=sh.EXCHANGES / iters,
        exchange_bytes_per_step=sh.EXCHANGE_BYTES / iters,
        exchange_ms_per_step=1e3 * sh.EXCHANGE_SECONDS / iters,
        exchange_wait_ms_per_step=1e3 * sh.EXCHANGE_WAIT_SECONDS / iters,
        k1_launches=sweep.LAUNCHES,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def _mesh_read(stp, iters):
    """A subtree rank's collectives (:func:`_collective_read`) and its
    block."""
    ids = stp.plan.np_ids
    return dict(
        _collective_read(iters), frontier=stp.frontier,
        local_rows=stp.plan.l_np,
        spine_rows=stp.sp.stage_start[stp.frontier],
        ghost_rows_this_rank=int((ids[stp.rank] < 0).sum()),
        ghost_rows_all_ranks=int((ids < 0).sum()))


def _flat_read(fp, iters):
    """A flat rank's collectives (:func:`_collective_read`) and its
    blocks: rows a block of each node space, and its real rows."""
    sp = fp.sp
    return dict(_collective_read(iters),
                blocks=[sp.np_pad, sp.nl_pad, sp.lf_pad],
                real_rows=[hi - lo for lo, hi in (fp.plan.real["np"],
                                                  fp.plan.real["nl"],
                                                  fp.plan.real["lf"])])


def _result_arrays(res, prefix=""):
    arrays = {f"{prefix}xi_history": res.xi_history,
              f"{prefix}delta_history": res.delta_history}
    for tree in (res.primal, res.dual):
        arrays.update({f"{prefix}{k}": np.asarray(v)
                       for k, v in tree._asdict().items()})
    return arrays


def _save_phase(base, phase, out, arrays):
    np.savez(base.format(phase) + ".npz", **arrays)
    with open(base.format(phase) + ".json", "w") as fh:
        json.dump(out, fh)


def _rank_subtree(mesh, base):
    """``mesh_demo_f64`` and ``mesh_config5_f32`` on this rank."""
    problem, x0 = demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, mesh=mesh)
    solver.operator_norm_sq()
    _mesh_counters()
    res = solver.solve(x0, max_iters=2000, tol=1e-3)
    out = dict(_mesh_read(solver.subtree, res.num_iters),
               device=str(solver.subtree.sp.device), iters=res.num_iters,
               converged=res.converged, xi=res.xi.tolist(), alpha=res.alpha,
               ms_per_step=1e3 * res.solve_time / res.num_iters,
               validate=max(solver.validate(res).values()))
    _save_phase(base, "mesh_demo_f64", out, _result_arrays(res))

    tic = time.perf_counter()
    controller, x0 = network_mpc_controller(**CONFIG5, offline="device",
                                            mesh=mesh)
    solver, _ = controller.solver_for_mode(0)
    solver.operator_norm_sq()
    setup_s = time.perf_counter() - tic
    _mesh_counters()
    run = controller.run(x0, **MESH_CONFIG5_RUN)
    res = solver.result
    out = dict(_mesh_read(solver.subtree, res.num_iters),
               nodes=solver.stacked.num_nodes, dtype=str(
                   solver.subtree.sp.dtype), setup_s=setup_s,
               power_iterations=solver.power_iterations,
               iters=res.num_iters, xi=res.xi.tolist(), alpha=res.alpha,
               ms_per_step=1e3 * res.solve_time / res.num_iters,
               inputs=run.inputs.tolist(), states=run.states.tolist())
    _save_phase(base, "mesh_config5_f32", out, _result_arrays(res))


def _rank_flat_demo(mesh, base, refs):
    """``mesh_flat_demo_f64`` on this rank: the demo on the flat layout
    (its collectives read over the plain solve), the ragged tree under
    "auto", three lanes in one batch, an Anderson window at the single
    card's step size."""
    problem, x0 = demo_problem()
    sweep.LAUNCHES = 0
    solver = rt.Solver(problem, dtype=torch.float64, mesh=mesh,
                       partition="flat")
    solver.operator_norm_sq()
    launches = sweep.LAUNCHES
    _mesh_counters()
    res = solver.solve(x0, **FLAT_DEMO)
    out = dict(_flat_read(solver.flat, res.num_iters),
               device=str(solver.flat.sp.device), iters=res.num_iters,
               converged=res.converged, xi=res.xi.tolist(), alpha=res.alpha,
               ms_per_step=1e3 * res.solve_time / res.num_iters,
               validate=max(solver.validate(res).values()))
    arrays = _result_arrays(res)
    launches += sweep.LAUNCHES
    sweep.LAUNCHES = 0
    ragged, rx0 = demo_problem(**RAGGED)
    rsolver = rt.Solver(ragged, dtype=torch.float64, mesh=mesh)
    rres = rsolver.solve(rx0, **FLAT_DEMO)
    x0 = np.asarray(x0)
    lanes = solver.solve_batch(np.stack([s * x0 for s in FLAT_BATCH_SCALES]),
                               **FLAT_DEMO)
    with _t_evals() as calls:
        anderson = solver.solve(x0, max_iters=FLAT_ANDERSON_WINDOW,
                                tol=1e-12, alpha=refs["demo_alpha"],
                                accel="anderson")
    out.update(ragged_flat=rsolver.flat is not None,
               ragged_subtree=rsolver.subtree is not None,
               ragged_iters=rres.num_iters,
               batch_iters=[r.num_iters for r in lanes],
               batch_converged=[r.converged for r in lanes],
               batch_s=lanes[0].solve_time,
               anderson_iters=anderson.num_iters,
               anderson_t_evals=calls["prox_f"],
               k1_launches_phase=launches + sweep.LAUNCHES)
    arrays.update(_result_arrays(rres, "ragged/"))
    arrays.update(_result_arrays(lanes[0], "lane0/"))
    arrays.update(_result_arrays(anderson, "anderson/"))
    _save_phase(base, "mesh_flat_demo_f64", out, arrays)


def _rank_flat_headline(mesh, base, refs):
    """``mesh_flat_headline_f64`` on this rank: BASELINE config 4 at full
    width on the flat layout, plain CP and SuperMann, capped, at the
    single card's step size."""
    problem, x0 = random_network_problem(**HEADLINE)
    tic = time.perf_counter()
    solver = rt.Solver(problem, dtype=torch.float64, mesh=mesh,
                       partition="flat")
    setup_s = time.perf_counter() - tic
    fp = solver.flat
    alpha = refs["headline_alpha"]
    _mesh_counters()
    cp = solver.solve(x0, alpha=alpha, **FLAT_HEADLINE_CP)
    out = dict(_flat_read(fp, cp.num_iters), nodes=solver.stacked.num_nodes,
               device=str(fp.sp.device), setup_s=setup_s,
               iters=cp.num_iters, xi=cp.xi.tolist(),
               ms_per_step=1e3 * cp.solve_time / cp.num_iters)
    arrays = _result_arrays(cp, "cp/")
    _mesh_counters()
    with _t_evals() as calls:
        sm = solver.solve(x0, alpha=alpha, **FLAT_HEADLINE_SUPERMANN)
    out["supermann"] = dict(
        _flat_read(fp, sm.num_iters), iters=sm.num_iters,
        t_evals=calls["prox_f"], xi=sm.xi.tolist(),
        ms_per_iter=1e3 * sm.solve_time / sm.num_iters)
    arrays.update(_result_arrays(sm, "supermann/"))
    _save_phase(base, "mesh_flat_headline_f64", out, arrays)


def rank_main(args):
    """One rank of the partitioned phases: a gloo group on localhost, a
    CUDA mesh; the subtree phases, then the flat ones (the single card's
    step sizes from ``out/refs.json``); each phase's numbers to
    ``out/{phase}.rank{r}.json``, its iterates to ``.npz``."""
    import torch.distributed as dist
    from raocp_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed("gloo",
                           init_method=f"tcp://127.0.0.1:{args.port}",
                           world_size=args.world, rank=args.rank,
                           timeout=MESH_GROUP_TIMEOUT)
    mesh = make_mesh("cuda")
    base = os.path.join(args.out, "{}.rank%d" % args.rank)
    with open(os.path.join(args.out, "refs.json")) as fh:
        refs = json.load(fh)
    _rank_subtree(mesh, base)
    _rank_flat_demo(mesh, base, refs)
    _rank_flat_headline(mesh, base, refs)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(out):
    """Start the ranks and wait for them; a rank that fails, or the run
    passing ``MESH_TIMEOUT``, kills the others and raises with the logs."""
    port = _free_port()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
            for r in range(MESH_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(MESH_WORLD), "--port", str(port), "--out", out],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(MESH_WORLD)]
    deadline = time.monotonic() + MESH_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * MESH_WORLD:
        for r, fh in enumerate(logs):
            fh.seek(0)
            sys.stderr.write(f"--- rank {r} (exit {codes[r]}) ---\n"
                             + fh.read()[-8000:])
        raise AssertionError(f"the mesh ranks exited with {codes}")
    for fh in logs:
        fh.close()


def _load_ranks(out, phase):
    got = []
    for r in range(MESH_WORLD):
        path = os.path.join(out, f"{phase}.rank{r}")
        with open(path + ".json") as fh:
            got.append((json.load(fh), dict(np.load(path + ".npz"))))
    return got


def _leaf_diffs(arrays, res, rel=False, prefix="", floor=0.0):
    """max |arrays[prefix + leaf] - res's leaf| for every iterate leaf (over
    the leaf's own inf-norm in ``res`` with ``rel``, or over ``floor``
    times the iterate's largest entry where that is more), on the rows of
    ``arrays`` (a flat result holds real rows, a padded one more)."""
    leaves = {k: np.asarray(v, dtype=np.float64)
              for tree in (res.primal, res.dual)
              for k, v in tree._asdict().items()}
    scale = floor * max(float(np.abs(v).max(initial=0.0))
                        for v in leaves.values())
    out = {}
    for k, v in leaves.items():
        got = np.asarray(arrays[prefix + k], dtype=np.float64)
        v = v[:got.shape[0]]
        d = float(np.abs(got - v).max(initial=0.0))
        if rel:
            d /= max(float(np.abs(v).max(initial=0.0)), scale, 1e-30)
        out[k] = d
    return out


def _hist_rel(arrays, key, res_hist):
    """max |history difference| over the history's largest entry (inf when
    the shapes or the unchecked rows differ)."""
    got = arrays[key]
    if got.shape != res_hist.shape \
            or not np.array_equal(np.isnan(got), np.isnan(res_hist)):
        return float("inf")
    return float(np.nanmax(np.abs(got - res_hist), initial=0.0)
                 / np.nanmax(np.abs(res_hist)))


def _ranks_agree(ranks, keys):
    """Both ranks returned the same arrays, bit for bit, and the same
    ``keys`` (their own timings, bytes, memory and rows aside)."""
    (a, arr_a), (b, arr_b) = ranks[0], ranks[1]
    same = arr_a.keys() == arr_b.keys() and all(
        np.array_equal(arr_a[k], arr_b[k], equal_nan=True) for k in arr_a)
    return same and all(a[k] == b[k] for k in keys)


def _per_rank(ranks, *keys):
    """{key: [rank 0's, rank 1's]} of a phase's numbers."""
    return {k: [r[k] for r, _ in ranks] for k in keys}


_COLLECTIVE_KEYS = ("all_reduce_ms_per_step", "all_reduce_wait_ms_per_step",
                    "exchange_ms_per_step", "exchange_wait_ms_per_step",
                    "exchange_bytes_per_step", "max_memory_allocated_bytes",
                    "ms_per_step")


def _flat_references(demo):
    """The single card's runs the flat phases are held against (made
    before the ranks start): the ragged demo, an Anderson window on the
    demo at its step size, and the headline in float64, plain CP and
    SuperMann, capped."""
    ragged, rx0 = demo_problem(**RAGGED)
    refs = {"ragged": rt.Solver(ragged, dtype=torch.float64,
                                device=DEV).solve(rx0, **FLAT_DEMO)}
    problem, x0 = demo_problem()
    with _t_evals() as calls:
        refs["anderson"] = rt.Solver(
            problem, dtype=torch.float64, device=DEV).solve(
            x0, max_iters=FLAT_ANDERSON_WINDOW, tol=1e-12, alpha=demo.alpha,
            accel="anderson")
    refs["anderson_t_evals"] = calls["prox_f"]
    problem, x0 = random_network_problem(**HEADLINE)
    solver = rt.Solver(problem, dtype=torch.float64, device=DEV)
    refs["headline_alpha"] = 0.999 / solver.operator_norm_sq()
    torch.cuda.reset_peak_memory_stats()
    with counted() as calls:
        refs["headline_cp"] = solver.solve(x0, alpha=refs["headline_alpha"],
                                           **FLAT_HEADLINE_CP)
    refs["headline_cp_k1"] = calls["k1"]
    refs["headline_cp_prox_f"] = calls["prox_f"]
    refs["headline_peak"] = torch.cuda.max_memory_allocated()
    with _t_evals() as calls:
        refs["headline_sm"] = solver.solve(
            x0, alpha=refs["headline_alpha"], **FLAT_HEADLINE_SUPERMANN)
    refs["headline_sm_t_evals"] = calls["prox_f"]
    refs["headline_nodes"] = solver.stacked.num_nodes
    del solver
    torch.cuda.empty_cache()
    return refs


def phase_mesh(demo):
    """The partitioned phases (module docstring). The single-card runs they
    are held against: ``demo`` (phase_parity's card solve), config 5's
    capped step, and :func:`_flat_references`, made here before the ranks
    start."""
    controller, x0 = network_mpc_controller(**CONFIG5, offline="device")
    solver, _ = controller.solver_for_mode(0)
    solver.operator_norm_sq()
    torch.cuda.reset_peak_memory_stats()
    with counted() as calls:
        run = controller.run(x0, **MESH_CONFIG5_RUN)
    single = solver.result
    single_peak = torch.cuda.max_memory_allocated()
    # the yardstick of float32's own rounding: the same step in float64
    controller, x0 = network_mpc_controller(**CONFIG5, offline="device",
                                            dtype=torch.float64)
    controller.run(x0, **MESH_CONFIG5_RUN)
    single64 = controller.solver_for_mode(0)[0].result
    del controller, solver
    torch.cuda.empty_cache()
    refs = _flat_references(demo)

    with tempfile.TemporaryDirectory() as out:
        with open(os.path.join(out, "refs.json"), "w") as fh:
            json.dump({"demo_alpha": demo.alpha,
                       "headline_alpha": refs["headline_alpha"]}, fh)
        tic = time.perf_counter()
        _run_ranks(out)
        ranks_s = time.perf_counter() - tic
        demo_ranks = _load_ranks(out, "mesh_demo_f64")
        c5_ranks = _load_ranks(out, "mesh_config5_f32")
        flat_ranks = _load_ranks(out, "mesh_flat_demo_f64")
        head_ranks = _load_ranks(out, "mesh_flat_headline_f64")

    got, arrays = demo_ranks[0]
    it_diff = max(_leaf_diffs(arrays, demo).values())
    hist = demo.xi_history
    hist_diff = float(np.abs(arrays["xi_history"] - hist).max()) \
        if arrays["xi_history"].shape == hist.shape else float("inf")
    agree = _ranks_agree(demo_ranks, ("iters", "xi", "alpha", "validate",
                                      "all_reduces", "k1_launches"))
    PATH_LAUNCHES["mesh_demo_f64"] = got["k1_launches"]
    emit("mesh_demo_f64", ranks=MESH_WORLD, backend="gloo",
         **{k: got[k] for k in ("device", "iters", "xi", "alpha", "validate",
                                "frontier", "local_rows", "spine_rows",
                                "ghost_rows_all_ranks", "all_reduces",
                                "all_reduces_per_step",
                                "all_reduce_bytes_per_step", "k1_launches")},
         **_per_rank(demo_ranks, "ms_per_step", "all_reduce_ms_per_step",
                     "all_reduce_wait_ms_per_step",
                     "max_memory_allocated_bytes"),
         single_card_ms_per_step=1e3 * demo.solve_time / demo.num_iters,
         single_card_alpha=demo.alpha,
         iterate_max_diff=it_diff, xi_history_max_diff=hist_diff,
         xi_history_scale=float(np.abs(hist).max()), ranks_agree=agree,
         ranks_s=ranks_s)
    check(got["converged"] and got["iters"] == 937,
          f"partitioned demo took {got['iters']} iterations, not 937")
    check(np.allclose(got["xi"], [9.9508e-4, 9.4106e-4, 9.5599e-4],
                      rtol=1e-3, atol=0), f"partitioned demo xi {got['xi']}")
    # the partitioned power iteration's step size differs from the single
    # card's in the last bits (2e-13 relative on the CPU), and xi divides
    # iterate differences by it: the history is held to 1e-12 of its
    # largest entry, the iterates to 1e-12
    check(it_diff <= 1e-12, f"partitioned demo iterates {it_diff} from the "
                            "single card's")
    check(hist_diff <= 1e-12 * float(np.abs(hist).max()),
          f"partitioned demo history {hist_diff} from the single card's")
    check(agree, "the two ranks' demo results differ")
    check(got["validate"] < 1e-10, f"partitioned demo validate "
                                   f"{got['validate']}")
    check(got["k1_launches"] == 0, "K1 ran on the partitioned demo")

    got, arrays = c5_ranks[0]
    by_leaf = _leaf_diffs(arrays, single, rel=True)
    it_rel = max(by_leaf.values())
    single_to_64 = _leaf_diffs(single.primal._asdict()
                               | single.dual._asdict(), single64, rel=True)
    part_to_64 = _leaf_diffs(arrays, single64, rel=True)
    ratio = {k: by_leaf[k] / max(single_to_64[k], 1e-30) for k in by_leaf}
    u_single = np.asarray(run.inputs)
    u_rel = float(np.abs(np.asarray(got["inputs"]) - u_single).max()
                  / np.abs(u_single).max())
    agree = _ranks_agree(c5_ranks, ("iters", "xi", "alpha", "inputs",
                                    "states", "all_reduces", "k1_launches"))
    finite = all(np.isfinite(arrays[k]).all() for k in by_leaf)
    PATH_LAUNCHES["mesh_config5_f32"] = got["k1_launches"]
    emit("mesh_config5_f32", ranks=MESH_WORLD, backend="gloo",
         **{k: got[k] for k in ("nodes", "dtype", "iters", "xi", "alpha",
                                "power_iterations", "frontier", "local_rows",
                                "spine_rows", "ghost_rows_all_ranks",
                                "all_reduces", "all_reduces_per_step",
                                "all_reduce_bytes_per_step", "k1_launches")},
         ghost_rows_per_rank=[r["ghost_rows_this_rank"]
                              for r, _ in c5_ranks],
         **_per_rank(c5_ranks, "setup_s", "ms_per_step",
                     "all_reduce_ms_per_step", "all_reduce_wait_ms_per_step",
                     "max_memory_allocated_bytes"),
         single_card_ms_per_step=1e3 * single.solve_time / single.num_iters,
         single_card_iters=single.num_iters, single_card_alpha=single.alpha,
         single_card_k1_launches=calls["k1"],
         single_card_max_memory_allocated_bytes=single_peak,
         iterate_max_rel_diff=it_rel, input_max_rel_diff=u_rel,
         rounding_ratio_by_leaf=ratio,
         iterate_rel_diff_by_leaf=by_leaf,
         single_f32_to_f64_rel_by_leaf=single_to_64,
         partitioned_f32_to_f64_rel_by_leaf=part_to_64,
         single_f64_iters=single64.num_iters,
         rounding_bound=MESH_CONFIG5_ROUNDING,
         input_tol=MESH_CONFIG5_INPUT_TOL, ranks_agree=agree,
         ranks_s=ranks_s)
    check(got["nodes"] == 88573, "config 5 is not the 88,573-node tree")
    check(finite and np.isfinite(got["xi"]).all(),
          "partitioned config 5 not finite")
    check(got["iters"] == single.num_iters,
          f"partitioned config 5 ran {got['iters']} iterations, the single "
          f"card {single.num_iters}")
    check(agree, "the two ranks' config-5 results differ")
    beyond = {k: d for k, d in by_leaf.items()
              if d > MESH_CONFIG5_ROUNDING * single_to_64[k] + 1e-6}
    check(not beyond, f"partitioned config 5 leaves {beyond} from the "
                      f"single card's, beyond {MESH_CONFIG5_ROUNDING} times "
                      f"its own float32 rounding {single_to_64}")
    check(u_rel <= MESH_CONFIG5_INPUT_TOL,
          f"partitioned config 5 input {u_rel} from the single card's")
    check(got["k1_launches"] == 0, "K1 ran on the partitioned config 5")

    _check_flat_demo(flat_ranks, demo, refs)
    _check_flat_headline(head_ranks, refs)


def _check_flat_demo(ranks, demo, refs):
    """``mesh_flat_demo_f64``: the demo on the flat layout against the
    single card (937 iterations, iterates to 1e-12), the ragged tree under
    "auto" (flat; the single card's count, iterates to 1e-12), three lanes
    (lane 0: 937, the single card's iterates), an Anderson window (the
    single card's T evaluations, iterates to 1e-10)."""
    got, arrays = ranks[0]
    it_diff = max(_leaf_diffs(arrays, demo).values())
    hist_rel = _hist_rel(arrays, "xi_history", demo.xi_history)
    ragged = refs["ragged"]
    ragged_diff = max(_leaf_diffs(arrays, ragged, prefix="ragged/").values())
    lane0_diff = max(_leaf_diffs(arrays, demo, prefix="lane0/").values())
    anderson = refs["anderson"]
    anderson_diff = max(_leaf_diffs(arrays, anderson,
                                    prefix="anderson/").values())
    agree = _ranks_agree(ranks, ("iters", "xi", "alpha", "validate",
                                 "exchanges", "all_reduces", "ragged_iters",
                                 "batch_iters", "anderson_iters",
                                 "anderson_t_evals", "k1_launches_phase"))
    PATH_LAUNCHES["mesh_flat_demo_f64"] = got["k1_launches_phase"]
    emit("mesh_flat_demo_f64", ranks=MESH_WORLD, backend="gloo",
         **{k: got[k] for k in (
             "device", "iters", "xi", "alpha", "validate", "exchanges",
             "exchanges_per_step", "all_reduces", "all_reduces_per_step",
             "all_reduce_bytes_per_step", "k1_launches_phase",
             "ragged_flat", "ragged_subtree", "ragged_iters", "batch_iters",
             "batch_converged", "anderson_iters", "anderson_t_evals")},
         **_per_rank(ranks, "blocks", "real_rows", "batch_s",
                     *_COLLECTIVE_KEYS),
         single_card_ms_per_step=1e3 * demo.solve_time / demo.num_iters,
         single_card_alpha=demo.alpha, iterate_max_diff=it_diff,
         xi_history_max_rel=hist_rel, ragged_single_iters=ragged.num_iters,
         ragged_iterate_max_diff=ragged_diff,
         lane0_iterate_max_diff=lane0_diff,
         anderson_single_iters=anderson.num_iters,
         anderson_single_t_evals=refs["anderson_t_evals"],
         anderson_iterate_max_diff=anderson_diff, ranks_agree=agree)
    check(got["converged"] and got["iters"] == 937,
          f"flat demo took {got['iters']} iterations, not 937")
    check(np.allclose(got["xi"], [9.9508e-4, 9.4106e-4, 9.5599e-4],
                      rtol=1e-3, atol=0), f"flat demo xi {got['xi']}")
    check(it_diff <= 1e-12 and hist_rel <= 1e-12,
          f"flat demo iterates {it_diff}, history {hist_rel} (relative) "
          "from the single card's")
    check(got["validate"] < 1e-10, f"flat demo validate {got['validate']}")
    check(got["ragged_flat"] and not got["ragged_subtree"]
          and got["ragged_iters"] == ragged.num_iters
          and ragged_diff <= 1e-12,
          f"ragged demo under 'auto': flat {got['ragged_flat']}, "
          f"{got['ragged_iters']} iterations (single card "
          f"{ragged.num_iters}), iterates {ragged_diff} apart")
    check(got["batch_iters"][0] == 937 and all(got["batch_converged"])
          and lane0_diff <= 1e-12,
          f"flat batch: {got['batch_iters']}, lane 0 {lane0_diff} from "
          "the single card's demo")
    check(got["anderson_t_evals"] == refs["anderson_t_evals"]
          and got["anderson_iters"] == anderson.num_iters
          and anderson_diff <= 1e-10,
          f"flat Anderson window: {got['anderson_t_evals']} T evaluations "
          f"(single card {refs['anderson_t_evals']}), iterates "
          f"{anderson_diff} apart")
    check(agree, "the two ranks' flat demo results differ")
    check(got["k1_launches_phase"] == 0, "K1 ran on the flat demo")


def _check_flat_headline(ranks, refs):
    """``mesh_flat_headline_f64``: BASELINE config 4 (9,841 nodes) on the
    flat layout, plain CP capped at 500 iterations and SuperMann at 100,
    each within FLAT_HEADLINE_REL of the single card's (K1 there)."""
    got, arrays = ranks[0]
    cp, sm = refs["headline_cp"], refs["headline_sm"]
    cp_leaf = _leaf_diffs(arrays, cp, rel=True, prefix="cp/",
                          floor=FLAT_NOISE_FLOOR)
    sm_leaf = _leaf_diffs(arrays, sm, rel=True, prefix="supermann/",
                          floor=FLAT_NOISE_FLOOR)
    cp_hist = _hist_rel(arrays, "cp/xi_history", cp.xi_history)
    sm_hist = _hist_rel(arrays, "supermann/xi_history", sm.xi_history)
    finite = all(np.isfinite(arrays[run + k]).all()
                 for run in ("cp/", "supermann/") for k in cp_leaf)
    gsm = got["supermann"]
    agree = _ranks_agree(ranks, ("iters", "xi", "exchanges", "all_reduces",
                                 "k1_launches")) \
        and ranks[0][0]["supermann"]["t_evals"] \
        == ranks[1][0]["supermann"]["t_evals"]
    PATH_LAUNCHES["mesh_flat_headline_f64"] = got["k1_launches"] \
        + gsm["k1_launches"]
    emit("mesh_flat_headline_f64", ranks=MESH_WORLD, backend="gloo",
         nodes=got["nodes"], dtype="torch.float64",
         **{k: got[k] for k in (
             "device", "iters", "xi", "exchanges", "exchanges_per_step",
             "all_reduces", "all_reduces_per_step",
             "all_reduce_bytes_per_step", "k1_launches")},
         **_per_rank(ranks, "blocks", "real_rows", "setup_s",
                     *_COLLECTIVE_KEYS),
         single_card_ms_per_step=1e3 * cp.solve_time / cp.num_iters,
         single_card_iters=cp.num_iters,
         single_card_k1_launches=refs["headline_cp_k1"],
         single_card_prox_f_calls=refs["headline_cp_prox_f"],
         single_card_max_memory_allocated_bytes=refs["headline_peak"],
         iterate_rel_diff_by_leaf=cp_leaf, xi_history_max_rel=cp_hist,
         supermann=dict(
             iters=gsm["iters"], t_evals=gsm["t_evals"], xi=gsm["xi"],
             exchanges_per_iter=gsm["exchanges_per_step"],
             all_reduces_per_iter=gsm["all_reduces_per_step"],
             k1_launches=gsm["k1_launches"],
             ms_per_iter=[r["supermann"]["ms_per_iter"] for r, _ in ranks],
             exchange_ms_per_iter=[r["supermann"]["exchange_ms_per_step"]
                                   for r, _ in ranks],
             exchange_wait_ms_per_iter=[
                 r["supermann"]["exchange_wait_ms_per_step"]
                 for r, _ in ranks],
             single_card_iters=sm.num_iters,
             single_card_t_evals=refs["headline_sm_t_evals"],
             single_card_ms_per_iter=1e3 * sm.solve_time / sm.num_iters,
             iterate_rel_diff_by_leaf=sm_leaf, xi_history_max_rel=sm_hist),
         rel_bound=FLAT_HEADLINE_REL, noise_floor=FLAT_NOISE_FLOOR,
         ranks_agree=agree)
    check(got["nodes"] == refs["headline_nodes"] == 9841,
          "the flat headline is not the 9,841-node tree")
    check(finite and np.isfinite(got["xi"]).all(),
          "flat headline not finite")
    check(got["iters"] == cp.num_iters,
          f"flat headline ran {got['iters']} iterations, the single card "
          f"{cp.num_iters}")
    check(max(cp_leaf.values()) <= FLAT_HEADLINE_REL
          and cp_hist <= FLAT_HEADLINE_REL,
          f"flat headline CP: iterates {cp_leaf}, history {cp_hist} "
          "(relative) from the single card's")
    check(gsm["iters"] == sm.num_iters
          and gsm["t_evals"] == refs["headline_sm_t_evals"]
          and max(sm_leaf.values()) <= FLAT_HEADLINE_REL
          and sm_hist <= FLAT_HEADLINE_REL,
          f"flat headline SuperMann: {gsm['iters']} iterations and "
          f"{gsm['t_evals']} T evaluations (single card {sm.num_iters}, "
          f"{refs['headline_sm_t_evals']}), iterates {sm_leaf}, history "
          f"{sm_hist} from the single card's")
    check(refs["headline_cp_k1"] == refs["headline_cp_prox_f"] > 0,
          "K1 not launched once per prox_f on the single card's headline")
    check(agree, "the two ranks' flat headline results differ")
    check(got["k1_launches"] == 0 and gsm["k1_launches"] == 0,
          "K1 ran on the flat headline")


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


def _k1_profile(fn, applies, planned, attempts=3):
    """K1 on the card per call of ``fn``, from a profile of ``applies``
    calls: the kernels it launches, their device time in ms, and the
    profiles taken. ``fn`` launches the same ``planned`` kernels on every
    call, so a profile holding fewer lost device events: it happened on
    the card twice, on launches whose results were right, once losing all
    of a trace's kernels and once one of 60. Each profile first puts a
    marker kernel on the card and waits for it, so that the tracer is
    recording before K1 launches; a profile that still holds fewer K1
    kernels than planned is taken again, up to ``attempts`` times in all.
    A profile with more is never retaken."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device=DEV).add_(1)
            torch.cuda.synchronize()
            for _ in range(applies):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        k1 = [ev for ev in events if ev.get("cat") == "kernel"
              and ("stage_kernel" in ev["name"]
                   or "apex_kernel" in ev["name"])]
        if len(k1) >= planned * applies:
            break
    return (len(k1) / applies, 1e-3 * sum(ev["dur"] for ev in k1) / applies,
            attempt)


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
        (row["device_launches_per_apply"], row["device_ms"],
         row["profiles_taken"]) = _k1_profile(
            lambda: sweep.project_dynamics_sweep(sp, x_in, u_in, x0), 20,
            row["launches_per_apply"])
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
                          "batch_socnet148_f32")):
    """``scripts/bench_batch.py``'s two measurements on the card: eight
    lanes solved to 1e-3 in one batch against eight sequential solves, at
    the headline (BASELINE config 4, in float32 and in float64) and at
    the SOC network (``soc_network_problem()`` with its defaults: 148
    nodes, not BASELINE config 3's 3,280; ``offline="device"``, float32).
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
        "batch_socnet148_f32": (soc_network_problem, torch.float32, 4000,
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
    ap.add_argument("--mesh", action="store_true",
                    help="run the partitioned phases alone (subtree, flat)")
    # one rank of the partitioned phases (the script starts itself so)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    smi = phase_device()
    phase_build()
    if args.mesh:
        problem, x0 = demo_problem()
        demo = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
            x0, max_iters=2000, tol=1e-3)
        phase_mesh(demo)
        print(smi, flush=True)
        return 0
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
    phase_mesh(demo)
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
