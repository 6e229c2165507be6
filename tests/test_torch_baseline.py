"""The port's BASELINE-config runner (``raocp_tpu_torch.scripts``) against
the JAX package on the CPU, in float64: configs 1 and 2 solved to 1e-3 by
both, configs 3 and 4 capped at 200 iterations, config 5's width in a
three-step closed loop and its chain's modes, K1's plans at the new
shapes, and the profile's trace parser.

Run as a script, this file writes the runner's reference,
``raocp_tpu_torch/scripts/jax_reference.json`` (the JAX package's results
for every row that ``bench_configs`` runs on configs 1-4, config 3 also at
the smoke's stride, and config 5's realised modes):

    JAX_PLATFORMS=cpu python tests/test_torch_baseline.py --write-reference
"""

import contextlib
import dataclasses
import io
import json
import os
import platform
import sys
import time

import numpy as np
import pytest

# as a script, the repo's packages come from the checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.solver import Solver as JaxSolver  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402
from raocp_tpu_torch.core.stacked import (build_stacked,  # noqa: E402
                                          from_numpy, to_numpy)
from raocp_tpu_torch.models import network_mpc_controller  # noqa: E402
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.scripts import (bench_components,  # noqa: E402
                                     bench_configs, profile_step)
from raocp_tpu_torch.scripts.bench_configs import (CONFIG5,  # noqa: E402
                                                   CONFIG5_RUN, CONFIGS,
                                                   SOLVE, STRIDED)
import test_torch_sweep  # noqa: E402


def _reference_runs():
    """(config, solve options) of every reference row, the longest last:
    the runner's rows of configs 1-4 and config 3 at ``check_every=25,
    unroll=25`` (the smoke's stride)."""
    runs = [(CONFIGS[k], {**SOLVE, **CONFIGS[k].solve}) for k in (1, 2)]
    c3, c4 = CONFIGS[3], CONFIGS[4]
    runs.append((c3, {**SOLVE, **c3.solve, **STRIDED}))
    runs.append((c3, {**SOLVE, **c3.solve}))
    runs.append((c4, {**SOLVE, **c4.solve}))
    runs.append((c4, {**SOLVE, "accel": c4.accel}))
    return runs


# config 5's modes depend only on the seed and the chain (not on the
# solves): drawn at its width with a tree of depth 2
CONFIG5_MODES_DEPTH = dict(num_stages=2, stopping_time=2)


def write_reference(path):
    """Solve every reference row with the JAX package (float64, CPU) and
    write the file after each row."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_configs_r05.jsonl")) as fh:
        tpu = [json.loads(line) for line in fh]
    tpu5 = next(r for r in tpu if r["config"] == "5_mpc_closed_loop_1e5")
    out = {"provenance": {
        "package": "raocp_tpu (the JAX package)", "jax": jax.__version__,
        "numpy": np.__version__,
        "platform": f"CPU, {os.cpu_count()} cores ({platform.system()} "
                    f"{platform.machine()})",
        "dtype": "float64",
        "command": "JAX_PLATFORMS=cpu python tests/test_torch_baseline.py "
                   "--write-reference"},
        "rows": []}

    # the sweeps' rows (tests/test_torch_sweeps.py) are written apart
    with open(path) as fh:
        out["sweeps"] = json.load(fh).get("sweeps", {})

    def dump():
        with open(path, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")

    kw = {**CONFIG5, **CONFIG5_MODES_DEPTH}
    controller, x0 = jax_models.network_mpc_controller(
        **kw, dtype=jnp.float64, offline="device")
    run = controller.run(x0, **CONFIG5_RUN)
    out["config5"] = {
        "modes": run.modes.tolist(),
        "modes_from": dict(problem=kw, run=CONFIG5_RUN),
        "tpu_f32_iterations_per_step": tpu5["iterations_per_step"],
        "tpu_f32_note": "context only: the JAX package on a TPU in float32 "
                        "(BENCH_configs_r05.jsonl), not a float64 count"}
    dump()
    for cfg, solve in _reference_runs():
        name = cfg.name if "accel" not in solve \
            else f"{cfg.name}_{solve['accel']}"
        problem, x0 = cfg.make(jax_models)
        solver = JaxSolver(problem, dtype=jnp.float64, offline=cfg.offline)
        tic = time.perf_counter()
        res = solver.solve(x0, **solve)
        seconds = time.perf_counter() - tic
        out["rows"].append(dict(
            config=name, solve=solve, num_nodes=problem.tree.num_nodes,
            converged=bool(res.converged), iterations=int(res.num_iters),
            objective=float(res.objective),
            xi=[float(v) for v in res.xi], alpha=float(res.alpha),
            max_violation=float(max(solver.validate(res).values())),
            cpu_seconds=seconds))
        print(json.dumps(out["rows"][-1]), flush=True)
        dump()


# ----------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def runner_rows():
    """The runner's rows of configs 1 and 2 on the CPU, as its command
    line prints them (each row solved twice, the second counted)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_configs.main(["--configs", "1,2", "--device", "cpu"])
    return {row["config"]: row
            for row in map(json.loads, out.getvalue().splitlines())}


@pytest.mark.parametrize("k", [1, 2])
def test_configs_1_2_match_jax_and_the_reference(runner_rows, k):
    """Configs 1 and 2 to 1e-3 with the runner's options in both packages:
    the same count, objectives within 1e-10 relative, and both equal to
    the committed reference's row, so the file came from the JAX
    package."""
    cfg = CONFIGS[k]
    solve = {**SOLVE, **cfg.solve}
    problem, x0 = cfg.make(jax_models)
    want = JaxSolver(problem, dtype=jnp.float64,
                     offline=cfg.offline).solve(x0, **solve)
    got = runner_rows[cfg.name]
    ref = bench_configs.reference_row(cfg.name, solve)
    assert got["converged"] and bool(want.converged)
    assert got["iterations"] == int(want.num_iters) == ref["iterations"] \
        == got["jax_iterations"]
    assert got["iterations"] == (1145, 581)[k - 1]
    assert got["objective"] == pytest.approx(float(want.objective),
                                             rel=1e-10, abs=0)
    assert ref["objective"] == pytest.approx(float(want.objective),
                                             rel=1e-12, abs=0)
    assert got["jax_objective"] == ref["objective"]


def test_runner_row_fields(runner_rows):
    """The JAX script's fields, the dtype, the counts of the counted solve
    (the plain version on the CPU: no K1 launch) and the reference's count
    beside the port's."""
    row = runner_rows[CONFIGS[1].name]
    for key in ("config", "num_nodes", "converged", "iterations",
                "iters_per_s", "time_to_tol_s", "setup_s", "max_violation",
                "accel", "dtype", "k1_launches", "prox_f_calls",
                "jax_iterations"):
        assert key in row, key
    assert (row["num_nodes"], row["dtype"], row["accel"]) == \
        (15, "torch.float64", None)
    assert row["k1_launches"] == 0
    assert row["prox_f_calls"] == row["iterations"] == 1145
    assert row["max_violation"] < 1e-10
    assert len(row["xi_last_two_checks"]) == 2


def test_runner_refuses_an_unknown_config():
    with pytest.raises(ValueError, match="no BASELINE config 6"):
        bench_configs.run_config(6, device="cpu")


def _leaves(tree):
    return {k: np.asarray(v, dtype=np.float64)
            for k, v in tree._asdict().items()}


@pytest.mark.parametrize("k", [3, 4])
def test_configs_3_4_iterates_match_jax_capped(k):
    """Configs 3 (3,280 nodes) and 4 (9,841) with the runner's options,
    capped at 200 iterations: the port's loop on the JAX package's stacked
    arrays (``from_numpy``) at JAX's step size ends within 1e-10 relative
    of JAX's iterates, leaf by leaf, and with JAX's residual history."""
    cfg = CONFIGS[k]
    problem, x0 = cfg.make(jax_models)
    jsolver = JaxSolver(problem, dtype=jnp.float64, offline=cfg.offline)
    opts = dict(max_iters=200, tol=1e-12)
    want = jsolver.solve(x0, **opts)
    sp = from_numpy(*to_numpy(jsolver.stacked), device="cpu",
                    dtype=torch.float64)
    z0 = sp.zero_primal()
    z0.x[0] = torch.as_tensor(x0, dtype=torch.float64)
    z, eta, iters, err, hist = solver_mod._run_cp(
        sp, z0, sp.zero_dual(), z0.x[0].clone(), want.alpha, want.alpha,
        1e-12, 200)
    assert iters == int(want.num_iters)
    np.testing.assert_allclose(hist[:, :3], np.asarray(want.xi_history),
                               rtol=1e-10, atol=0)
    got = {**_leaves(z), **_leaves(eta)}
    ref = {**_leaves(want.primal), **_leaves(want.dual)}
    for name, v in ref.items():
        scale = max(np.abs(v).max(initial=0.0), 1e-300)
        assert np.abs(got[name] - v).max(initial=0.0) <= 1e-10 * scale, name


@pytest.fixture(scope="module")
def config5_loops():
    """Config 5's width (100 states, 40 inputs, 3 modes) on a tree of
    depth 2: the JAX package's and the port's controllers, each after
    three closed-loop steps at the runner's options."""
    kw = {**CONFIG5, **CONFIG5_MODES_DEPTH}
    run_kw = {**CONFIG5_RUN, "num_steps": 3}
    jctl, x0 = jax_models.network_mpc_controller(
        **kw, dtype=jnp.float64, offline="device")
    pctl, px0 = network_mpc_controller(**kw, dtype=torch.float64,
                                       offline="device", device="cpu")
    np.testing.assert_array_equal(px0, x0)
    return jctl.run(x0, **run_kw), (pctl, px0), pctl.run(px0, **run_kw)


def test_config5_width_closed_loop_matches_jax(config5_loops):
    """Three closed-loop steps at config 5's width in both packages: the
    same modes, the same counts a step, and the total cost within 1e-9
    relative."""
    want, _, got = config5_loops
    np.testing.assert_array_equal(got.modes, want.modes)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    assert got.converged and bool(want.converged)
    assert got.total_cost == pytest.approx(want.total_cost, rel=1e-9, abs=0)


def test_config5_modes_are_the_references(config5_loops):
    """The port's closed loop draws config 5's five modes as the JAX
    package's did (the reference file): they depend on the seed and the
    chain alone, so one iteration a step at depth 2, unchunked, draws
    them."""
    ref = bench_configs.jax_reference()["config5"]
    _, (pctl, x0), _ = config5_loops
    run = pctl.run(x0, **{**CONFIG5_RUN, "max_iters": 1,
                          "chunk_iters": None})
    assert run.modes.tolist() == ref["modes"]
    assert len(ref["modes"]) == CONFIG5_RUN["num_steps"] + 1
    assert len(ref["tpu_f32_iterations_per_step"]) == \
        CONFIG5_RUN["num_steps"]


def test_reference_holds_every_row_the_runner_runs():
    """Every row the runner and the smoke hold a count against is in the
    file, converged, with its provenance."""
    ref = bench_configs.jax_reference()
    assert ref["provenance"]["dtype"] == "float64"
    assert "write-reference" in ref["provenance"]["command"]
    for cfg, solve in _reference_runs():
        name = cfg.name if "accel" not in solve \
            else f"{cfg.name}_{solve['accel']}"
        row = bench_configs.reference_row(name, solve)
        assert row is not None and row["converged"], name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_k1_plans_the_baseline_shapes(k, dtype):
    """Configs 1-3 as their runner stacks them (n/m = 2/1, 10/5, 20/8;
    configs 1-2 with host tables) are K1's: every stacked tensor is
    contiguous, the schedule covers every stage once each way within its
    limits, and every product's packed weights hold its operand."""
    cfg = CONFIGS[k]
    spec, _ = cfg.make()
    sp = build_stacked(spec, dtype=getattr(torch, dtype),
                       offline=cfg.offline, device="cpu")
    assert sweep.sweep_eligible(sp)
    for f in dataclasses.fields(sp):
        v = getattr(sp, f.name)
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                assert t.is_contiguous(), f.name
    shaped = lambda name, dt: sp                       # noqa: E731
    test_torch_sweep.test_schedule_covers_every_stage_once_each_way(
        shaped, cfg.name, dtype)
    test_torch_sweep.test_packed_weights_hold_every_operand(
        shaped, cfg.name, dtype)
    plan = sweep.sweep_schedule(sp)
    assert plan["launch_count"] == (1, 1, 11)[k - 1]


def test_trace_summary():
    """The profile's parser: wall from the first device event's start to
    the last one's end, busy time the union of the device events'
    intervals (a copy that overlaps a kernel counts once), K1's kernels by
    name, each ``raocp.*`` span's self time and the idle gaps put down to
    the innermost span open at their middles; other events are left out."""
    def ev(cat, name, ts, dur):
        return dict(cat=cat, name=name, ts=ts, dur=dur)

    events = [ev("kernel", "void stage_kernel<float>", 0.0, 40.0),
              ev("kernel", "elementwise", 50.0, 20.0),
              ev("gpu_memcpy", "copy", 60.0, 20.0),
              ev("kernel", "apex_kernel", 90.0, 10.0),
              ev("kernel", "elementwise", 190.0, 10.0),
              ev("cpu_op", "aten::add", 0.0, 200.0),
              ev("user_annotation", "other", 140.0, 10.0),
              ev("user_annotation", "raocp.solve", 0.0, 100.0),
              ev("user_annotation", "raocp.loop.drive", 5.0, 90.0),
              ev("user_annotation", "raocp.loop.launch", 10.0, 10.0),
              ev("user_annotation", "raocp.loop.launch", 120.0, 50.0)]
    got = profile_step.summarize_trace(events, steps=2, top=2)
    assert got["wall_ms_per_step"] == pytest.approx(0.1)
    assert got["device_ms_per_step"] == pytest.approx(0.045)
    assert got["device_busy_share"] == pytest.approx(0.45)
    assert got["launches_per_step"] == 2.5
    assert got["k1_share_of_device"] == pytest.approx(0.5)
    assert [t["name"] for t in got["top_kernels"]] == \
        ["void stage_kernel<float>", "elementwise"]
    assert got["span_self_ms_per_step"] == pytest.approx(
        {"raocp.solve": 0.005, "raocp.loop.drive": 0.04,
         "raocp.loop.launch": 0.03})
    # gaps [40, 50] and [80, 90] in the drive, [100, 190] in a launch
    assert got["idle_ms_per_step_by_span"] == pytest.approx(
        {"raocp.loop.drive": 0.01, "raocp.loop.launch": 0.045})
    bare = profile_step.summarize_trace(events[:5], steps=2)
    assert bare["idle_ms_per_step_by_span"] == pytest.approx({"none": 0.055})
    assert bare["span_self_ms_per_step"] == {}
    with pytest.raises(ValueError):
        profile_step.summarize_trace([], steps=1)


def test_profiles_need_a_card():
    """The profile and the component timings read the card's trace: on a
    CPU problem they raise, and report nothing."""
    problem, x0 = CONFIGS[1].make()
    solver = solver_mod.Solver(problem, device="cpu")
    with pytest.raises(RuntimeError, match="not on a card"):
        profile_step.profile_solve(solver, x0, 2)
    with pytest.raises(RuntimeError, match="not on one"):
        bench_components.time_components(solver.stacked)
    # every component runs on the CPU
    for name, fn in bench_components.components(solver.stacked).items():
        assert fn() is not None, name


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-reference"]:
        raise SystemExit(__doc__)
    write_reference(str(bench_configs._REFERENCE))
