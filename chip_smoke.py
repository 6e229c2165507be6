"""Smoke run of raocp_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py               # the smoke run (about 8-11 minutes)
    python3 chip_smoke.py --baseline    # BASELINE configs 1-5 to 1e-3, and
                                        # the batch rows
        [--configs 1,2,3,4,5,batch] [--dtypes float64,float32]
        [--config5-steps 5]
    python3 chip_smoke.py --profile     # where a CP step's time goes: the
                                        # headline's step and components,
                                        # config 5's step
    python3 chip_smoke.py --mesh        # the partitioned phases alone
                                        # (subtree and flat)
    python3 chip_smoke.py --loop        # loop_graph alone: the graph
                                        # loop against the host loop
    python3 chip_smoke.py --scale       # the scale runs, the option
        [--parts scale_88573,...]       # sweeps, the batch and scaling
                                        # harnesses: their full rows
    python3 chip_smoke.py --roofline    # the roofline at 9,841, 88,573
        [--parts roofline_88573,...]    # and 797,161 nodes, K1 against
                                        # the stage path, the loop-control
                                        # sweep: their full rows

Builds the port's CUDA kernel (K1, the dynamics-projection sweep) from
``raocp_tpu_torch/csrc``, holds it against its plain torch version on the
card (at the shapes of every path below, BASELINE configs 1-3, config
5's width, the 88,573- and 797,161-node trees of the scale runs and
batches of 8 and 3 lanes included; each case with its time,
the plain version's, the least time the card could take for the same
operations and bytes, and its launches counted in a profile), and then
measures the CP step's components against the least time the card could
take for their work, holds K1 against the torch stage path, and then
drives the port's paths, each with the launch counts set to 0 just before
it and read just after:

* ``roofline_headline``: every row of ``scripts/roofline.py`` at the
  headline (9,841 nodes, float32): each component's operations and
  compulsory bytes (``ops/work.py``), wall and device time, launches and
  bound; a device time under its bound fails the run (the count is
  wrong);
* ``stage_ab``: ``scripts/bench_pallas.py``'s five trees (its JAX
  counterpart's four regimes and BASELINE config 5's 88,573 nodes as the
  closed loop builds them), K1 and the stage path timed and held against
  each other to ``STAGE_AB_REL``;

* ``parity_*``: the demo's 937 iterations in float64 on the card, and a
  uniform 121-node tree through K1 against the CPU;
* ``chunked_demo_f64``: the demo in 300-iteration chunks, the same history;
* ``baseline_config{1,2,3}_f64``: BASELINE configs 1, 2 and 3 (15, 127 and
  3,280 nodes) through ``raocp_tpu_torch.scripts.bench_configs.run_config``
  in float64 to 1e-3, configs 1-2 with the runner's options (1,145 and 581
  iterations), config 3 at ``check_every=25, unroll=25``; each count equal
  to the JAX package's for the same options and each objective within 1e-8
  relative of its (``scripts/jax_reference.json``);
* ``headline_f32``: ``Solver(problem).solve(x0)`` (the card is the default
  device) at the
  50-state, 20-input, 3-mode, 8-stage (9,841-node) configuration;
* ``mpc_config5_f32``: ``network_mpc_controller(offline="device")`` at
  BASELINE config 5's full size (100 states, 40 inputs, 88,573 nodes),
  two closed-loop steps;
* ``loop_graph_headline_f32`` and ``loop_graph_config5_f32``: the device
  loop (CUDA graphs of its check periods, every path above and below runs
  it) against the host loop (``solver._host_loop()``) in one process, in
  turns, best of ``LOOP_GRAPH_REPEATS``: the headline to 1e-3 and one
  config-5 closed-loop step. Each loop's iter/s, wall µs beside device µs
  an iteration (a trace of ``LOOP_GRAPH_PROFILED`` steps), busy share,
  host reads, wasted steps, capture seconds and peak memory; the graph
  loop must replay, read at most one flag a period, give the host loop's
  count and iterates bit for bit, and launch K1 once per ``prox_f`` call
  per step run;
* ``scale_88573_f32``: ``scripts/bench_scale.py``'s problem (a 50-state,
  20-input network fully branched for 10 stages, 88,573 nodes) through
  ``bench_scale.run_tree``: the power iteration, then 250 CP steps
  (the runner's 1,000 are ``--scale``'s); finite residuals, K1 launches
  equal to ``prox_f`` calls;
* ``scale_797161_f32``: ``scripts/bench_1e6.py``'s problem (12 stages,
  797,161 nodes, a 531,441-row leaf stage) through the same function: the
  tree, the build, the loose power iteration, 50 CP steps with the peak
  device memory after each; then 25 steps through K1 held against the same
  25 steps through the plain sweep at the same step size
  (``SCALE_STEPS_REL``);
* ``relax_config2_f64``: ``scripts/bench_relax.py``'s relax-1.8 row of
  BASELINE config 2 in float64, its count the JAX package's;
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
no JAX.

``--baseline`` runs, instead of the smoke phases, the whole five-config
runner (``scripts/bench_configs.py``, every row solved twice, the second
timed): configs 1-4 in float64, each plain row's count equal to the JAX
package's float64 count and its objective within 1e-8 relative; configs
1-4 in float32, each count within ``F32_COUNT_SLACK`` of that count;
config 4's SuperMann row converged, its objective within
``SUPERMANN_OBJECTIVE_REL`` of the plain row's; config 5's closed loop in
float32 (``--config5-steps``, default 5), every step converged and the
JAX package's realised modes, its counts printed beside the JAX package's
float32 counts from a TPU (context); and ``scripts/bench_batch.py``'s two
measurements (``batch``): eight lanes of the headline (in float32 and in
float64) and of ``soc_network_problem()`` with its defaults (the SOC
network, 148 nodes; not BASELINE config 3's 3,280) to 1e-3 in one batch
against eight sequential solves. ``--configs`` and ``--dtypes`` pick a
part of it. K1 launches equal ``prox_f`` calls on every row.
``--scale`` runs each of these in a process of its own and checks its
rows: ``bench_scale`` (1,000 CP steps, best of 3), ``bench_1e6`` (50 steps,
and once to 1e-3), the 797,161-node step's profile (20 steps, with the
Solver's own power iteration), ``bench_relax`` and ``bench_accel`` in
float64 and float32 (one timed solve a row; every plain CP count in
float64 the JAX package's, in float32 within ``F32_COUNT_SLACK`` of it;
the accelerators' counts reported), ``bench_batch`` (the 148-node SOC
network), ``bench_scaling --device cuda`` at one and two ranks, and
(``f2``) the eight float32 headline lanes to 1e-3 at the JAX package's
step size (ROADMAP F2). K1 launches equal ``prox_f`` calls on every row
whose tree is K1's.
``--roofline`` runs, each in a process of its own, ``scripts/roofline.py``
at 8, 10 and 12 stages (9,841, 88,573 and 797,161 nodes; the last at 20
applies), ``scripts/bench_pallas.py`` (200 applies a path) and
``scripts/bench_sweep.py`` (five ``(check_every, unroll)`` pairs with K1
and under ``stage_path()``, 200 iterations, best of 3), with the same
checks as the smoke's phases.
``--profile`` runs ``scripts/profile_step.py`` on 100 CP steps of the
headline (``check_every=25, unroll=25``) and of config 5 (the closed
loop's options) with ``solve(profile_dir=...)`` and prints, from each
trace, the card's busy share of the step, its launches and its kernels by
time; and ``scripts/bench_components.py``'s table at the headline: each
component's wall ms beside its device ms and launches.
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
from raocp_tpu_torch.ops import prox, sweep, work  # noqa: E402
from raocp_tpu_torch.scripts import (bench_batch,  # noqa: E402
                                     bench_components, bench_configs,
                                     bench_pallas, bench_relax, bench_scale,
                                     profile_step, roofline)
from raocp_tpu_torch.scripts.bench_batch import batch_lanes  # noqa: E402
from raocp_tpu_torch.scripts.bench_configs import (CONFIGS,  # noqa: E402
                                                   counted_calls)

DEV = torch.device("cuda", 0)
SMALL = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
             stopping_time=4)
# BASELINE config 4 (the headline), config 5's width (4 stages, 40 nodes)
# and its full 88,573-node tree, as the runner builds them
HEADLINE = CONFIGS[4].problem
CONFIG5 = bench_configs.CONFIG5
CONFIG5_WIDTH = dict(CONFIG5, num_stages=3, stopping_time=3)
# the scale_88573_f32 phase's CP steps (bench_scale runs 1,000)
SCALE_SMOKE_ITERS = 250
# scale_797161_f32: 25 CP steps through K1 against the same 25 through the
# plain sweep, float32, the same step size. The two round differently (one
# apply agrees to 3.3e-7 of the output's largest entry at worst, PERF.md)
# and CP steps are nonexpansive, so 25 steps of such rounding stay near
# 25 x 1e-6: each iterate leaf within SCALE_STEPS_REL of its largest entry,
# a leaf below SCALE_NOISE_FLOOR of the iterate's largest entry against
# that floor
SCALE_STEPS = 25
SCALE_STEPS_REL = 1e-4
SCALE_NOISE_FLOOR = 1e-6
# the JAX package's float32 count on this problem (BENCH_configs_r05.jsonl,
# config 4): context only, not asserted
JAX_F32_ITERS = 10174
# the port's float32 count at the headline on an H100 (PERF.md)
HEADLINE_F32_ITERS = 10175
# K1 launches of each driven path
PATH_LAUNCHES = {}
# loop_graph: runs of each loop, in turns; the steps profiled for device
# time and busy share
LOOP_GRAPH_REPEATS = 3
LOOP_GRAPH_PROFILED = 100
# roofline_headline: applies timed and traced a row (the script's own are
# 100 and 20)
ROOFLINE_APPLIES = 30
ROOFLINE_TRACED = 10
# stage_ab: K1 against the stage path, float32, relative to the output's
# largest entry: both sum the same products in other orders over up to 14
# stages of up to 300-term sums (config 5: c n = 300), as the K1 cases
# against the plain version do (1e-4 there)
STAGE_AB_REL = 1e-4
STAGE_AB_APPLIES = 20
STAGE_AB_TRACED = 5
# how far, as a share of its sequential count, a float32 lane's count may
# be from its sequential solve's to 1e-3 (baseline_batch); and a float32
# row's count from the JAX package's float64 count (--baseline): one ulp of
# the step size moves a float32 count by 5% (ROADMAP F2)
F32_COUNT_SLACK = 0.1
# a float64 BASELINE row's objective against the JAX package's, relative
F64_OBJECTIVE_REL = 1e-8
# config 4's SuperMann objective against its plain row's, relative. Both
# stop at xi <= 1e-3, which leaves the objective far looser than that: the
# JAX package's own SuperMann row stops 2.7e-3 from its plain row
# (29.3904 against 29.4701, scripts/jax_reference.json), so the bound is
# a little under four times that gap; a wrong solution is off by more
SUPERMANN_OBJECTIVE_REL = 1e-2
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


_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line of ``phase``, with the seconds since the script
    started (``elapsed_s``: where the run's time limit goes)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def counted(path=None):
    """Set the K1 launch count to 0 and count ``prox_f`` calls (the T
    evaluations of a CP step) while a path runs; read both after it, and
    keep the launches under ``path``. Both count what ran on the card,
    graph replays included; ``calls["loop"]`` holds what the device loop
    ran meanwhile (``solver.LOOP_COUNTS``: steps, the steps wasted past
    convergence, replays, captures, host reads)."""
    torch.cuda.synchronize()
    sweep.LAUNCHES = 0
    loop = dict(solver_mod.LOOP_COUNTS)
    with counted_calls() as calls:
        yield calls
        torch.cuda.synchronize()
    calls["loop"] = {k: v - loop[k] for k, v in
                     solver_mod.LOOP_COUNTS.items()}
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
    with counted_calls() as calls:
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
    with counted_calls() as calls:
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
    with counted_calls() as calls:
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
    with counted_calls() as calls:
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


def _network(kwargs):
    """``random_network_problem(**kwargs)`` as a K1 case's problem."""
    return bench_configs.Config("network", "random_network_problem", kwargs,
                                "host", {})


def _sweep_inputs(cfg, dtype, pad, lanes=None):
    """The problem of ``cfg`` (a :class:`bench_configs.Config`, stacked as
    its runner's Solver stacks it but for the padding) and K1's inputs on
    the card: x [np_pad, n], u [nl_pad, m] and x0 [n], or with ``lanes``
    x [B, np_pad, n], u [B, nl_pad, m] and x0 [B, n]."""
    spec, x0 = cfg.make()
    sp = build_stacked(spec, dtype=dtype, pad_multiple=pad,
                       offline=cfg.offline, device=DEV)
    rng = np.random.default_rng(0)
    lead = () if lanes is None else (lanes,)
    x_in = torch.as_tensor(rng.standard_normal(lead + (sp.np_pad, sp.n)),
                           dtype=dtype, device=DEV)
    u_in = torch.as_tensor(rng.standard_normal(lead + (sp.nl_pad, sp.m)),
                           dtype=dtype, device=DEV)
    x0 = x0 if lanes is None else batch_lanes(x0, lanes)
    return sp, x_in, u_in, torch.as_tensor(x0, dtype=dtype, device=DEV)


def _recorded_calls(events, prefix):
    """The device records of each range named ``prefix...`` in a Chrome
    trace whose every launch, copy and set made on the host has its record
    from the card; a range with a record missing is left out."""
    records = {ev["args"]["correlation"]: ev for ev in events
               if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "correlation" in ev.get("args", {})}
    launches = [ev for ev in events if ev.get("cat") == "cuda_runtime"
                and any(w in ev["name"]
                        for w in ("LaunchKernel", "Memcpy", "Memset"))]
    out = []
    for span in events:
        if span.get("cat") != "user_annotation" \
                or not span["name"].startswith(prefix):
            continue
        made = [records.get(ev["args"].get("correlation"))
                for ev in launches
                if span["ts"] <= ev["ts"] <= span["ts"] + span["dur"]]
        if made and all(made):
            out.append(made)
    return out


def _k1_profile(fn, applies, attempts=3):
    """K1 on the card per call of ``fn``, from a profile of ``applies``
    calls, each in a range of its own: the kernels it launches, their
    device time in ms, the profiles taken, and the calls left out. The
    card's tracer loses device records (seen on the card, on launches whose
    results were right: all of a trace's kernels, one of 60, three of 20
    in three profiles running, at least one of 420 in five), but it keeps the
    host's launch calls. So a call counts only where every launch, copy
    and set it made on the host has its record from the card, and the
    numbers are those of the calls that count; where fewer than half of
    them count, the profile is taken again, up to ``attempts`` times in
    all. A call that counts and holds other K1 kernels than planned is
    the kernel's fault, not the tracer's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(solver_mod.TRACE_PAD_S)
            for i in range(applies):
                with record_function(f"k1_apply_{i}"):
                    fn()
            torch.cuda.synchronize()
            time.sleep(solver_mod.TRACE_PAD_S)
        with tempfile.TemporaryDirectory() as folder:
            path = os.path.join(folder, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        counted = [[ev for ev in made if profile_step.is_k1(ev["name"])]
                   for made in _recorded_calls(events, "k1_apply_")]
        if 2 * len(counted) >= applies:
            break
    k1 = [ev for call in counted for ev in call]
    calls = max(len(counted), 1)
    return (len(k1) / calls, 1e-3 * sum(ev["dur"] for ev in k1) / calls,
            attempt, applies - len(counted))


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
    card could take for its work (``ops/work.py``'s ``bound``: the larger
    of its operations over the element type's peak product rate and its
    compulsory bytes over the memory rate)."""
    plan = sweep.sweep_schedule(sp, lanes)
    count = sweep.sweep_work(sp, lanes)
    bound_s, bound_by = work.bound(count, sp.dtype)
    return dict(
        lanes=lanes, launches_per_apply=plan["launch_count"],
        apex_stages=plan["apex_stages"], apex_tile=plan["apex_tile"],
        apex_grid=lanes,
        stage_launches=" ".join(
            f"{la['direction'][0]}{la['stages'][0]}:tm{la['tm']}"
            f"xt{la['tile']}xg{la['grid']}"
            for la in plan["launches"] if la["kind"] == "stage"),
        flop=count["flop"], bytes=count["bytes"],
        bound_ms=1e3 * bound_s, bound_by=bound_by,
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


def _check_roofline_row(what, row):
    """A roofline row's numbers are finite and its device time is at or
    above its bound (below it, ``ops/work.py`` counted too much)."""
    check(all(np.isfinite(row[k]) for k in ("wall_us", "device_us",
                                            "bound_us", "launches")),
          f"{what} {row['component']}: a number is not finite")
    check(row["launches"] > 0, f"{what} {row['component']}: nothing ran on "
                               "the card")
    check(row["device_us"] >= row["bound_us"],
          f"{what} {row['component']}: {row['device_us']} us on the card, "
          f"under its bound of {row['bound_us']} us: the count is wrong")


def phase_roofline_headline():
    """Every roofline row at the headline (``scripts/roofline.py``, fewer
    applies than the script's own)."""
    sp, x0 = roofline.problem(8, DEV)
    for row in roofline.rows(sp, x0, applies=ROOFLINE_APPLIES,
                             traced=ROOFLINE_TRACED):
        emit("roofline_headline", **row)
        _check_roofline_row("roofline_headline", row)


def _check_ab_row(what, row):
    """K1 and the stage path agree to ``STAGE_AB_REL`` of the output's
    largest entry; K1 counted once an apply and the stage path never."""
    check(row["finite"], f"{what} {row['config']}: not finite")
    check(row["max_rel_diff"] <= STAGE_AB_REL,
          f"{what} {row['config']}: K1 and the stage path differ by "
          f"{row['max_rel_diff']} of the output's largest entry")
    check(row["k1_counted_per_apply"] == 1
          and row["stage_counted_per_apply"] == 0,
          f"{what} {row['config']}: K1 counted "
          f"{row['k1_counted_per_apply']} / {row['stage_counted_per_apply']}"
          " an apply of K1 / of the stage path")
    check(row["stage_k1_launches"] == 0,
          f"{what} {row['config']}: a K1 kernel in the stage path's trace")


def phase_stage_ab():
    """K1 against the torch stage path (``scripts/bench_pallas.py``) at its
    five configs, fewer applies than the script's own."""
    for name in bench_pallas.CONFIGS:
        tic = time.perf_counter()
        sp, x0 = bench_pallas.stacked(name, DEV)
        build = time.perf_counter() - tic
        row = bench_pallas.ab_row(name, sp, x0, applies=STAGE_AB_APPLIES,
                                  traced=STAGE_AB_TRACED)
        emit("stage_ab", build_s=build, **row)
        _check_ab_row("stage_ab", row)
        del sp


def phase_kernel():
    """K1 against its plain version on the card, unbatched and batched.
    The error is relative to the output's inf-norm; ghost rows must be
    exactly zero in every lane; a second apply on the same buffers must
    give the same bits; the kernels one apply puts on the card (counted in
    a profile of 20 applies, which also gives their device time) must be
    the schedule's. A batch's lanes are also held
    against the unbatched kernel on each lane, and one lane must be the
    unbatched call to the bit."""
    small, headline = _network(SMALL), _network(HEADLINE)
    config5_width = _network(CONFIG5_WIDTH)
    cases = (("a_small_f64", small, torch.float64, 4, 1e-12, None),
             ("b_small_f32", small, torch.float32, 4, 1e-5, None),
             # 8 sequential stages of up to c*n+m = 170-term float32 sums,
             # summed in another order than cuBLAS's
             ("c_headline_f32", headline, torch.float32, 8, 1e-4, None),
             # config 5's width: the widest rows, 40 nodes
             ("d_config5_width_f64", config5_width, torch.float64, 4, 1e-12,
              None),
             ("e_config5_width_f32", config5_width, torch.float32, 4, 1e-4,
              None),
             # the shapes the mpc_config5_f32 path hands K1: 88,573 nodes,
             # parent stages of up to 19,683 rows, persistent blocks
             ("f_config5_full_f32", _network(CONFIG5), torch.float32, 1, 1e-4,
              None),
             ("g_headline_f64", headline, torch.float64, 8, 1e-12, None),
             # m no multiple of 4 (rows of 72 bytes: 8-byte copies, scalar
             # stores), stages that are no multiples of their tiles, node
             # spaces padded to multiples of 5
             ("h_odd_width_f32", _network(dict(HEADLINE, num_inputs=18)),
              torch.float32, 5, 1e-4, None),
             # the shapes the batch_headline_f32 path hands K1: 8 lanes,
             # 78,728 rows; and the uniform tree in 3 lanes of float64
             ("i_headline_b8_f32", headline, torch.float32, 8, 1e-6, 8),
             ("j_small_b3_f64", small, torch.float64, 4, 1e-14, 3),
             # the shapes the baseline_config{1,2,3}_f64 paths hand K1 (no
             # padding, the runner's offline tables): n=2, m=1 on 15 nodes
             # (every nonleaf stage in the apex); n=10, m=5 on 127 nodes;
             # n=20, m=8 on 3,280 nodes. In float32, the small cases' and
             # the headline's tolerances
             ("k_config1_f64", CONFIGS[1], torch.float64, 1, 1e-12, None),
             ("l_config1_f32", CONFIGS[1], torch.float32, 1, 1e-5, None),
             ("m_config2_f64", CONFIGS[2], torch.float64, 1, 1e-12, None),
             ("n_config2_f32", CONFIGS[2], torch.float32, 1, 1e-5, None),
             ("o_config3_f64", CONFIGS[3], torch.float64, 1, 1e-12, None),
             ("p_config3_f32", CONFIGS[3], torch.float32, 1, 1e-4, None),
             # the shapes the scale_* paths hand K1 (n=50, m=20): 88,573
             # nodes (stages of up to 19,683 parents) and 797,161 nodes
             # (177,147 parents of the 531,441-row leaf stage)
             ("q_scale_88573_f32", _network(bench_scale.tree_kwargs(10)),
              torch.float32, 1, 1e-6, None),
             ("r_scale_797161_f32", _network(bench_scale.tree_kwargs(12)),
              torch.float32, 1, 1e-6, None))
    # a lane of a batch against the unbatched kernel: tiles of other rows,
    # so split-K sums in another order
    lane_tol = {torch.float32: 1e-6, torch.float64: 1e-14}
    out = {}
    for name, cfg, dtype, pad, tol, lanes in cases:
        sp, x_in, u_in, x0 = _sweep_inputs(cfg, dtype, pad, lanes)
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
         row["profiles_taken"], row["profiled_calls_left_out"]) = \
            _k1_profile(lambda: sweep.project_dynamics_sweep(
                sp, x_in, u_in, x0), 20)
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
    wasted = calls["loop"]["wasted_steps"]
    emit("parity_small_f64", gpu_iters=gpu.num_iters,
         cpu_iters=cpu.num_iters, gpu_objective=gpu.objective,
         cpu_objective=cpu.objective, k1_launches=calls["k1"],
         wasted_steps=wasted, graph_replays=calls["loop"]["replays"])
    check(gpu.converged and gpu.num_iters == cpu.num_iters,
          "CUDA and CPU iteration counts differ")
    check(abs(gpu.objective - cpu.objective) <= 1e-9,
          "CUDA and CPU objectives differ")
    check(calls["k1"] == calls["prox_f"] == gpu.num_iters + wasted
          == calls["loop"]["steps"] and calls["loop"]["replays"] > 0,
          f"K1 not launched once per CP step run: {calls}")
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


def _reference(row):
    """The JAX package's float64 row for ``row``'s config and options."""
    ref = bench_configs.reference_row(row["config"], row["solve"])
    check(ref is not None, f"no JAX reference for {row['config']} solved "
                           f"with {row['solve']}")
    return ref


def _check_plain_row(row, phase):
    """A plain CP row of the runner against the JAX package's float64 row:
    converged; in float64 the same count and the objective within
    ``F64_OBJECTIVE_REL``, in float32 the count within ``F32_COUNT_SLACK``;
    K1 launched once per ``prox_f`` call."""
    ref = _reference(row)
    check(row["converged"], f"{phase}: did not converge ({row['xi']})")
    if row["dtype"] == "torch.float64":
        check(row["iterations"] == ref["iterations"],
              f"{phase}: {row['iterations']} iterations, JAX "
              f"{ref['iterations']} (xi at the last two checks "
              f"{row['xi_last_two_checks']}, alpha {row['alpha']!r}, JAX's "
              f"{ref['alpha']!r})")
        rel = abs(row["objective"] - ref["objective"]) / abs(ref["objective"])
        check(rel <= F64_OBJECTIVE_REL,
              f"{phase}: objective {row['objective']!r} is {rel} from JAX's "
              f"{ref['objective']!r}")
    else:
        check(abs(row["iterations"] - ref["iterations"])
              <= F32_COUNT_SLACK * ref["iterations"],
              f"{phase}: {row['iterations']} iterations, further than "
              f"{F32_COUNT_SLACK:.0%} from JAX's float64 {ref['iterations']}")
    check(row["k1_launches"] == row["prox_f_calls"] > 0,
          f"{phase}: K1 launches {row['k1_launches']} != prox_f calls "
          f"{row['prox_f_calls']}")


def phase_baseline_configs():
    """BASELINE configs 1-3 in float64 on the card, through the runner:
    configs 1 and 2 with its options, config 3 at its production stride;
    each held against the JAX package's count and objective."""
    for k, options in ((1, {}), (2, {}), (3, bench_configs.STRIDED)):
        path = f"baseline_config{k}_f64"
        with counted(path) as calls:
            (row,) = bench_configs.run_config(k, torch.float64, DEV,
                                              repeats=1, **options)
        emit(path, **row, path_k1_launches=calls["k1"],
             path_prox_f_calls=calls["prox_f"])
        _check_plain_row(row, path)
        check(calls["k1"] == calls["prox_f"] == row["k1_launches"],
              f"{path}: K1 launches {calls['k1']} != prox_f calls "
              f"{calls['prox_f']}")


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
         prox_f_calls=calls["prox_f"], loop=calls["loop"],
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    check(res.converged and np.isfinite(res.xi).all() and finite,
          "headline solve did not converge to finite values")
    check(res.num_iters == HEADLINE_F32_ITERS,
          f"the headline took {res.num_iters} iterations, not "
          f"{HEADLINE_F32_ITERS}")
    check(calls["loop"]["replays"] > 0
          and calls["prox_f"] == calls["loop"]["steps"],
          f"the headline's loop: {calls['loop']}")
    check(res.primal.x.shape == (sp.np_pad, sp.n), "primal shape")
    check(calls["k1"] > 0 and calls["k1"] == calls["prox_f"],
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")


def _loop_runs(solve):
    """``solve()`` through the graph loop and the host loop
    (``solver._host_loop()``) in turns, ``LOOP_GRAPH_REPEATS`` times each:
    per loop the runs' outputs, counts and peak device memory above what
    was allocated when the run began."""
    runs = {"graph": [], "host": []}
    for _ in range(LOOP_GRAPH_REPEATS):
        for loop in runs:
            scope = solver_mod._host_loop if loop == "host" \
                else contextlib.nullcontext
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            with scope(), counted() as calls:
                out = solve()
            runs[loop].append(dict(
                out, calls=calls,
                peak=torch.cuda.max_memory_allocated() - start))
    return runs


def _loop_row(runs, profiled):
    """One loop's numbers: the best run's rate and wall µs an iteration;
    the device µs an iteration of a profile of its steps, and the busy
    share as that over the best run's wall µs (the trace's own share also
    counts the solve's set-up in its short window); host reads and wasted
    steps, its counts, capture seconds and peak device memory."""
    best = min(runs, key=lambda r: r["seconds"])
    iters = best["iters"]
    loop = best["calls"]["loop"]
    wall_us = 1e6 * best["seconds"] / iters
    device_us = 1e3 * profiled["device_ms_per_step"]
    return dict(
        iters=iters, seconds=[r["seconds"] for r in runs],
        iters_per_second=iters / best["seconds"],
        wall_us_per_iter=wall_us, device_us_per_iter=device_us,
        busy_share=device_us / wall_us,
        trace_busy_share=profiled["device_busy_share"],
        profile_wall_us_per_iter=1e3 * profiled["wall_ms_per_step"],
        profile_launches_per_step=profiled["launches_per_step"],
        host_reads=loop["host_reads"],
        host_reads_per_iter=loop["host_reads"] / iters,
        wasted_steps=loop["wasted_steps"], steps_run=loop["steps"],
        graph_replays=loop["replays"],
        capture_seconds=sum(r["calls"]["loop"]["capture_seconds"]
                            for r in runs),
        captures=sum(r["calls"]["loop"]["captures"] for r in runs),
        k1_launches=best["calls"]["k1"], prox_f_calls=best["calls"]["prox_f"],
        peak_memory_over_start_bytes=max(r["peak"] for r in runs))


def _check_loops(phase, runs, graph, period):
    """The graph loop against the host loop: the same count and iterates
    in every run, the graph path taken (replays, at most one host read a
    period and one a chunk), K1 launches equal ``prox_f`` calls equal the
    steps run."""
    want = runs["host"][0]
    for r in runs["graph"] + runs["host"]:
        check(r["iters"] == want["iters"]
              and all(np.array_equal(a, b) for a, b in
                      zip(r["arrays"], want["arrays"])),
              f"{phase}: a run's iterates differ from the host loop's")
    check(graph["graph_replays"] > 0,
          f"{phase}: the graph loop replayed nothing")
    check(graph["host_reads"] <= -(-graph["iters"] // period) + 2,
          f"{phase}: {graph['host_reads']} host reads in "
          f"{graph['iters']} iterations")
    for r in runs["graph"]:
        c = r["calls"]
        check(c["prox_f"] == c["loop"]["steps"] == r["iters"]
              + c["loop"]["wasted_steps"]
              and (c["k1"] == c["prox_f"] or not r["k1_path"]),
              f"{phase}: K1 {c['k1']}, prox_f {c['prox_f']}, steps "
              f"{c['loop']['steps']}, iterations {r['iters']}")


def phase_loop_graph():
    """The device loop's CUDA graphs against the host loop in one process:
    the headline (float32, ``check_every=25``, to 1e-3) and one closed-loop
    step of BASELINE config 5 (88,573 nodes, the closed loop's options),
    each loop in turns, best of ``LOOP_GRAPH_REPEATS``; device time and
    busy share from a profile of ``LOOP_GRAPH_PROFILED`` steps of each."""
    problem, x0 = random_network_problem(**HEADLINE)
    solver = rt.Solver(problem)             # the default device: the card
    solver.operator_norm_sq()
    k1_path = sweep.sweep_eligible(solver.stacked)

    def headline():
        res = solver.solve(x0, max_iters=20000, tol=1e-3, check_every=25)
        return dict(iters=res.num_iters, seconds=res.solve_time,
                    arrays=(*res.primal, *res.dual), k1_path=k1_path)

    controller, cx0 = network_mpc_controller(**CONFIG5, offline="device")
    csolver = controller.solver_for_mode(0)[0]
    csolver.operator_norm_sq()
    copts = dict(check_every=25, unroll=5, chunk_iters=1250, max_iters=2500,
                 relax="auto")

    def config5_step():
        run = controller.run(cx0, num_steps=1, initial_mode=0, **copts)
        res = csolver.result
        return dict(iters=res.num_iters, seconds=res.solve_time,
                    arrays=(run.states, run.inputs, *res.primal, *res.dual),
                    k1_path=sweep.sweep_eligible(csolver.stacked))

    popts = {"headline": dict(check_every=25),
             "config5": dict(check_every=25, unroll=5, relax="auto")}
    for name, solve, psolver, px0 in (
            ("headline", headline, solver, x0),
            ("config5", config5_step, csolver, cx0)):
        phase = f"loop_graph_{name}_f32"
        runs = _loop_runs(solve)
        rows = {loop: _loop_row(runs[loop], profile_step.profile_solve(
                    psolver, px0, LOOP_GRAPH_PROFILED, loop=loop,
                    **popts[name]))
                for loop in runs}
        graph, host = rows["graph"], rows["host"]
        emit(phase, nodes=psolver.stacked.num_nodes, graph=graph, host=host,
             graph_over_host_iters_per_second=graph["iters_per_second"]
             / host["iters_per_second"], repeats=LOOP_GRAPH_REPEATS,
             profiled_steps=LOOP_GRAPH_PROFILED)
        _check_loops(phase, runs, graph, 25)
        if name == "headline":
            check(graph["iters"] == HEADLINE_F32_ITERS,
                  f"{phase}: {graph['iters']} iterations, not "
                  f"{HEADLINE_F32_ITERS}")


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


def phase_scale_88573():
    """``bench_scale``'s problem (88,573 nodes, n=50, m=20, float32,
    ``offline="device"``) through ``bench_scale.run_tree``: the power
    iteration at the Solver's tolerance, then ``SCALE_SMOKE_ITERS`` CP
    steps at ``check_every=25``; K1 launches equal ``prox_f`` calls."""
    with counted("scale_88573_f32") as calls:
        row = bench_scale.run_tree(10, iters=SCALE_SMOKE_ITERS,
                                   device=DEV).row
    emit("scale_88573_f32", **row, path_k1_launches=calls["k1"],
         path_prox_f_calls=calls["prox_f"])
    check(row["num_nodes"] == 88573, "not the 88,573-node tree")
    check(row["finite"] and np.isfinite(row["xi"]).all(),
          f"the 88,573-node iterates are not finite: xi {row['xi']}")
    check(row["iters"] == SCALE_SMOKE_ITERS,
          f"{row['iters']} CP steps, not {SCALE_SMOKE_ITERS}")
    check(calls["k1"] == calls["prox_f"] > 0,
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")


@contextlib.contextmanager
def _plain_sweep():
    """``prox_f``'s dynamics projection through the plain torch sweep while
    the body runs: the reference a K1 run is held against."""
    real = prox.project_dynamics_sweep
    prox.project_dynamics_sweep = sweep.project_dynamics_sweep_ref
    try:
        yield
    finally:
        prox.project_dynamics_sweep = real


def phase_scale_797161():
    """``bench_1e6``'s problem (797,161 nodes, n=50, m=20, float32,
    ``offline="device"``) through ``bench_scale.run_tree``: the tree, the
    build, the loose power iteration (1e-6), 50 CP steps (K1 launches
    equal ``prox_f`` calls); then ``SCALE_STEPS`` steps through K1 held
    against the same steps through the plain sweep at the same step
    size."""
    with counted("scale_797161_f32") as calls:
        run = bench_scale.run_tree(12, iters=50, power_rel_tol=1e-6,
                                   device=DEV)
    row = run.row
    sp = run.solver.stacked
    x0 = torch.as_tensor(run.x0, dtype=sp.dtype, device=DEV)

    def steps():
        z0 = sp.zero_primal()
        z0.x[0] = x0
        z, eta, *_ = solver_mod._run_cp(
            sp, z0, sp.zero_dual(), x0, row["alpha"], row["alpha"], 0.0,
            SCALE_STEPS, check_every=25, unroll=5)
        return {**z._asdict(), **eta._asdict()}

    with counted() as k1_calls:
        got = steps()
    with _plain_sweep(), counted() as plain_calls:
        ref = steps()
    largest = max(float(v.abs().max()) for v in ref.values())
    rel = {k: float((got[k] - v).abs().max())
           / max(float(v.abs().max()), SCALE_NOISE_FLOOR * largest, 1e-30)
           for k, v in ref.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    del got, ref, run
    torch.cuda.empty_cache()
    emit("scale_797161_f32", **row, path_k1_launches=calls["k1"],
         path_prox_f_calls=calls["prox_f"], nonleaf=sp.num_nonleaf,
         leaf_stage_rows=sp.num_nodes - sp.stage_start[-2],
         k1_fields=_plan_fields(sp), steps_vs_plain=SCALE_STEPS,
         steps_k1_launches=k1_calls["k1"],
         steps_plain_k1_launches=plain_calls["k1"],
         steps_rel_diff_by_leaf=rel, steps_rel_bound=SCALE_STEPS_REL,
         steps_noise_floor=SCALE_NOISE_FLOOR)
    check(row["num_nodes"] == 797161 and sp.num_nonleaf == 265720,
          "not the 797,161-node tree")
    check(row["finite"] and finite and np.isfinite(row["xi"]).all(),
          f"the 797,161-node iterates are not finite: xi {row['xi']}")
    check(row["iters"] == 50, f"{row['iters']} CP steps, not 50")
    check(calls["k1"] == calls["prox_f"] > 0,
          f"K1 launches {calls['k1']} != prox_f calls {calls['prox_f']}")
    check(k1_calls["k1"] == k1_calls["prox_f"] == SCALE_STEPS
          and plain_calls["k1"] == 0
          and plain_calls["prox_f"] == SCALE_STEPS,
          f"the K1 run made {k1_calls} and the plain run {plain_calls}")
    check(max(rel.values()) <= SCALE_STEPS_REL,
          f"{SCALE_STEPS} steps through K1 are {rel} from the plain "
          f"sweep's, beyond {SCALE_STEPS_REL}")


def phase_relax_config2():
    """``bench_relax``'s relax-1.8 row of BASELINE config 2 in float64 on
    the card, held to the JAX package's count for the same options."""
    with counted("relax_config2_f64") as calls:
        (row,) = bench_relax.run_relax(2, torch.float64, DEV, repeats=1,
                                       settings=("relax1.8",))
    emit("relax_config2_f64", **row, path_k1_launches=calls["k1"],
         path_prox_f_calls=calls["prox_f"])
    check(row["converged"] and row["jax_iterations"] is not None
          and row["iterations"] == row["jax_iterations"],
          f"config 2 at relax 1.8: {row['iterations']} iterations, JAX "
          f"{row['jax_iterations']}")
    check(calls["k1"] == calls["prox_f"] > 0,
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
    x0s = batch_lanes(x0)
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
    """``scripts/bench_batch.py``'s two measurements on the card
    (``bench_batch.run_batch``): eight lanes solved to 1e-3 in one batch
    against eight sequential solves, at the headline (BASELINE config 4, in
    float32 and in float64) and at the SOC network
    (``soc_network_problem()`` with its defaults: 148 nodes, not BASELINE
    config 3's 3,280; ``offline="device"``, float32). Each lane must end as
    its sequential solve does, its count within one check period (25) of
    its sequential count in float64 and within ``bench_batch``'s
    ``F32_LANE_SLACK`` in float32 (``run_batch`` raises otherwise); K1
    launches equal the batch's ``prox_f`` calls."""
    configs = {
        "batch_config4_f32": (lambda: random_network_problem(**HEADLINE),
                              torch.float32, 20000, {}, None),
        "batch_config4_f64": (lambda: random_network_problem(**HEADLINE),
                              torch.float64, 20000, {}, None),
        "batch_socnet148_f32": (soc_network_problem, torch.float32, 4000,
                                dict(offline="device"),
                                bench_batch.batch_key(False, 8, 4000))}
    for name in names:
        make, dtype, max_iters, extra, key = configs[name]
        problem, x0 = make()
        solver = rt.Solver(problem, dtype=dtype, device=DEV, **extra)
        solver.operator_norm_sq()
        row = bench_batch.run_batch(
            solver, batch_lanes(x0), max_iters, name=name,
            reference=None if key is None
            else bench_configs.reference_row(*key))
        emit(name, **row)
        check(not sweep.sweep_eligible(solver.stacked)
              or row["k1_launches"] == row["prox_f_calls"] > 0,
              f"{name}: K1 launches {row['k1_launches']} != prox_f calls "
              f"{row['prox_f_calls']}")


def baseline(configs, dtypes, config5_steps):
    """The five-config runner (``scripts/bench_configs.py``, every row
    solved twice, the second timed) on the card: configs 1-4 in each of
    ``dtypes``, each plain row against the JAX package's float64 row
    (:func:`_check_plain_row`), config 4's SuperMann row converged to an
    objective within ``SUPERMANN_OBJECTIVE_REL`` of the plain row's (its
    count is not held: the accelerators amplify rounding); config 5's
    closed loop in float32, ``config5_steps`` steps, every step converged
    with the JAX package's realised modes."""
    for dtype in dtypes:
        tag = "f64" if dtype == torch.float64 else "f32"
        for k in sorted(c for c in configs if c in CONFIGS):
            rows = bench_configs.run_config(k, dtype, DEV)
            for row in rows:
                phase = f"baseline_{row['config']}_{tag}"
                emit(phase, **row)
                if row["accel"] is None:
                    _check_plain_row(row, phase)
                    continue
                plain = rows[0]["objective"]
                rel = abs(row["objective"] - plain) / abs(plain)
                check(row["converged"] and rel <= SUPERMANN_OBJECTIVE_REL,
                      f"{phase}: converged {row['converged']}, objective "
                      f"{rel} from the plain row's")
                check(row["k1_launches"] == row["prox_f_calls"] > 0,
                      f"{phase}: K1 launches {row['k1_launches']} != "
                      f"prox_f calls {row['prox_f_calls']}")
    if 5 in configs:
        (row,) = bench_configs.run_config(5, torch.float32, DEV,
                                          num_steps=config5_steps)
        emit("baseline_5_mpc_closed_loop_1e5_f32", **row)
        check(row["converged"], f"a config-5 step did not converge: "
                                f"{row['iterations_per_step']}")
        check(row["modes"] == row["jax_modes"],
              f"config 5's modes {row['modes']}, JAX's {row['jax_modes']}")
        check(row["k1_launches"] == row["prox_f_calls"] > 0,
              f"config 5: K1 launches {row['k1_launches']} != prox_f calls "
              f"{row['prox_f_calls']}")


def profile():
    """Where the time of a CP step goes (``scripts/profile_step.py``): the
    headline's 100 steps at ``check_every=25, unroll=25`` and config 5's
    at the closed loop's options, each from the trace of
    ``solve(profile_dir=...)``; and the headline's components
    (``scripts/bench_components.py``), wall beside device time."""
    for name in ("headline", "config5"):
        got = profile_step.run_profile(name, device=DEV)
        emit(f"profile_{name}_f32", **got)
        check(got["k1_launches"] == got["prox_f_calls"] > 0
              and got["device_ms_per_step"] > 0,
              f"{name}'s profile: K1 launches {got['k1_launches']}, prox_f "
              f"calls {got['prox_f_calls']}")
    problem, _ = CONFIGS[4].make()
    sp = rt.Solver(problem, dtype=torch.float32, offline="device",
                   device=DEV).stacked
    rows = bench_components.time_components(sp)
    emit("components_headline_f32", nodes=sp.num_nodes, rows=rows)
    check(all(r["device_ms"] > 0 and r["launches"] > 0 for r in rows),
          "a component put nothing on the card")


# JAX's float32 step size at the headline (0.999 / lambda_max in float32;
# the port's own is 0.24975, two ulps away: ROADMAP F2)
F2_ALPHA = 0.24974997
# --scale's parts, each run in a process of its own: the runner and its
# arguments (a runner module of raocp_tpu_torch.scripts, or this script)
_MOD = "raocp_tpu_torch.scripts."
SCALE_PARTS = {
    "scale_88573": ["-m", _MOD + "bench_scale"],
    "tree797161": ["-m", _MOD + "bench_1e6"],
    "tree797161_tol": ["-m", _MOD + "bench_1e6", "--tol", "1e-3"],
    "profile797161": ["-m", _MOD + "profile_step", "--config", "tree797161",
                      "--steps", "20"],
    "relax_f64": ["-m", _MOD + "bench_relax", "--dtype", "float64",
                  "--repeats", "1"],
    "relax_f32": ["-m", _MOD + "bench_relax", "--dtype", "float32",
                  "--repeats", "1"],
    "accel_f64": ["-m", _MOD + "bench_accel", "--dtype", "float64",
                  "--repeats", "1"],
    "accel_f32": ["-m", _MOD + "bench_accel", "--dtype", "float32",
                  "--repeats", "1"],
    "batch": ["-m", _MOD + "bench_batch"],
    "scaling": ["-m", _MOD + "bench_scaling", "--device", "cuda", "--ranks",
                "1,2"],
    "f2": [os.path.abspath(__file__), "--part", "f2"],
}
SCALE_PART_TIMEOUT = 3000


def part_f2():
    """The eight float32 headline lanes of ``batch_config4_f32`` to 1e-3 at
    JAX's step size ``F2_ALPHA``, with lane 6 solved alone beside them."""
    problem, x0 = random_network_problem(**HEADLINE)
    solver = rt.Solver(problem, device=DEV)
    row = bench_batch.run_batch(solver, batch_lanes(x0), 20000,
                                alpha=F2_ALPHA, sequential=(6,),
                                name="f2_headline_b8_f32")
    print(json.dumps(row), flush=True)
    check(row["k1_launches"] == row["prox_f_calls"] > 0,
          f"K1 launches {row['k1_launches']} != prox_f calls "
          f"{row['prox_f_calls']}")


def _check_scale_row(part, row):
    """What a --scale part's row must hold: K1 launched once per
    ``prox_f`` call wherever it is on the row's path on the card, finite
    results; a plain CP row of the sweeps in float64 on the JAX package's
    count, in float32 within ``F32_COUNT_SLACK`` of it."""
    if row.get("k1_path") and row["device"].startswith("cuda"):
        check(row["k1_launches"] == row["prox_f_calls"] > 0,
              f"{part}: K1 launches {row['k1_launches']} != prox_f calls "
              f"{row['prox_f_calls']}")
    if "finite" in row:
        check(row["finite"], f"{part}: the iterates are not finite")
    if row.get("tol"):
        check(row["converged"], f"{part}: did not reach {row['tol']}")
    if part.startswith(("relax", "accel")) \
            and "accel" not in row["solve"]:
        ref = row["jax_iterations"]
        check(ref is not None, f"{part}: no JAX count for {row['solve']}")
        if row["dtype"] == "torch.float64":
            check(row["iterations"] == ref,
                  f"{part} {row['config']} {row['solve']}: "
                  f"{row['iterations']} iterations, JAX {ref}")
        else:
            check(abs(row["iterations"] - ref) <= F32_COUNT_SLACK * ref,
                  f"{part} {row['config']} {row['solve']}: "
                  f"{row['iterations']} iterations, further than "
                  f"{F32_COUNT_SLACK:.0%} from JAX's float64 {ref}")


# --roofline's parts, each run in a process of its own: the roofline at
# each tree size (the 797,161-node tree with fewer applies: its trace is
# large), the A/B of K1 against the stage path and the loop-control sweep
ROOFLINE_PARTS = {
    "roofline_9841": ["-m", _MOD + "roofline", "--stages", "8"],
    "roofline_88573": ["-m", _MOD + "roofline", "--stages", "10"],
    "roofline_797161": ["-m", _MOD + "roofline", "--stages", "12",
                        "--applies", "20", "--traced", "20"],
    "bench_pallas": ["-m", _MOD + "bench_pallas"],
    "bench_sweep": ["-m", _MOD + "bench_sweep"],
}


def _check_roofline_part(part, row):
    """What a --roofline part's row must hold: a roofline row at or above
    its bound, an A/B row within ``STAGE_AB_REL``, a sweep row finite with
    K1 launched once per ``prox_f`` call on its K1 path and never on the
    stage path."""
    if "component" in row:
        _check_roofline_row(part, row)
    elif "max_rel_diff" in row:
        _check_ab_row(part, row)
    else:
        check(row["finite"], f"{part} {row}: not finite")
        want = row["prox_f_calls"] if row["path"] == "k1" else 0
        check(row["k1_launches"] == want and row["prox_f_calls"] > 0,
              f"{part} {row['path']} ({row['check_every']}, "
              f"{row['unroll']}): K1 launches {row['k1_launches']}, prox_f "
              f"calls {row['prox_f_calls']}")


def run_parts(flag, table, parts, check_row):
    """The long rows of ``flag`` (module docstring), each part of
    ``table`` in a process of its own; every part runs, and the run fails
    after the last if any part failed or a row broke ``check_row``."""
    failed = []
    for part in parts:
        tic = time.perf_counter()
        proc = subprocess.run([sys.executable, *table[part]],
                              capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=SCALE_PART_TIMEOUT)
        rows = [json.loads(line) for line in proc.stdout.splitlines()
                if line.startswith("{")]
        errors = []
        for row in rows:
            emit(f"{flag}_{part}", **row)
            try:
                check_row(part, row)
            except AssertionError as e:
                errors.append(str(e))
        if proc.returncode != 0:
            errors.append(f"exit {proc.returncode}: {proc.stderr[-3000:]}")
        emit(f"{flag}_{part}_done", seconds=time.perf_counter() - tic,
             exit=proc.returncode, rows=len(rows), errors=errors)
        if errors or not rows:
            failed.append(part)
    check(not failed, f"--{flag} parts failed: {failed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="store_true",
                    help="run BASELINE configs 1-5 to 1e-3 and the batch "
                         "rows instead")
    ap.add_argument("--configs", default="1,2,3,4,5,batch",
                    help="--baseline's part: configs of 1-5, 'batch'")
    ap.add_argument("--dtypes", default="float64,float32",
                    help="--baseline's dtypes of configs 1-4")
    ap.add_argument("--config5-steps", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="profile the headline's and config 5's CP step "
                         "and the headline's components instead")
    ap.add_argument("--mesh", action="store_true",
                    help="run the partitioned phases alone (subtree, flat)")
    ap.add_argument("--loop", action="store_true",
                    help="run the loop_graph phase alone (the graph loop "
                         "against the host loop)")
    ap.add_argument("--scale", action="store_true",
                    help="run the scale, sweep, batch and partition "
                         "runners' full rows instead")
    ap.add_argument("--roofline", action="store_true",
                    help="run the roofline at three tree sizes, the A/B of "
                         "K1 against the stage path and the loop-control "
                         "sweep instead")
    ap.add_argument("--parts",
                    help="--scale's or --roofline's parts (default: all)")
    # one in-process part of --scale (the script starts itself so)
    ap.add_argument("--part", choices=("f2",))
    # one rank of the partitioned phases (the script starts itself so)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.part == "f2":
        solver_mod.pin_full_precision()
        part_f2()
        return 0
    smi = phase_device()
    phase_build()
    if args.scale or args.roofline:
        flag, table, check_row = (
            ("scale", SCALE_PARTS, _check_scale_row) if args.scale
            else ("roofline", ROOFLINE_PARTS, _check_roofline_part))
        run_parts(flag, table,
                  args.parts.split(",") if args.parts else list(table),
                  check_row)
        print(smi, flush=True)
        return 0
    if args.loop:
        phase_loop_graph()
        print(smi, flush=True)
        return 0
    if args.mesh:
        problem, x0 = demo_problem()
        demo = rt.Solver(problem, dtype=torch.float64, device=DEV).solve(
            x0, max_iters=2000, tol=1e-3)
        phase_mesh(demo)
        print(smi, flush=True)
        return 0
    if args.baseline or args.profile:
        if args.profile:
            profile()
        else:
            parts = args.configs.split(",")
            baseline({int(c) for c in parts if c != "batch"},
                     [getattr(torch, d) for d in args.dtypes.split(",")],
                     args.config5_steps)
            if "batch" in parts:
                baseline_batch()
        print(smi, flush=True)
        return 0
    kernel = phase_kernel()
    phase_matmul_context()
    phase_roofline_headline()
    phase_stage_ab()
    demo = phase_parity()
    phase_chunked(demo)
    phase_baseline_configs()
    phase_headline()
    phase_mpc_config5()
    phase_loop_graph()
    phase_scale_88573()
    phase_scale_797161()
    phase_relax_config2()
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
