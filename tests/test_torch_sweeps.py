"""The port's accelerator sweep (``raocp_tpu_torch.scripts.bench_accel``)
against the JAX package on the CPU, in float64: at BASELINE config 1 plain
CP and relax 1.8 take JAX's counts, and Anderson and SuperMann agree with
JAX's inside the windows where two roundings still agree; every reference
row the sweeps and the batch runner hold a count against is in
``jax_reference.json`` (``tests/test_torch_relax.py`` holds
``bench_relax``).

Run as a script, this file writes those rows (the ``sweeps`` part of
``raocp_tpu_torch/scripts/jax_reference.json``): the JAX package's float64
results on the CPU of every row that ``bench_relax``, ``bench_accel`` and
``bench_batch`` run, keyed by the stacking and the solve's options, one
process a row:

    JAX_PLATFORMS=cpu python tests/test_torch_sweeps.py --write-reference \
        [--jobs 7]
"""

import json
import multiprocessing
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

import raocp_tpu.accel as jax_accel  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.solver import Solver as JaxSolver  # noqa: E402
from raocp_tpu.solver import _run_cp as jax_run_cp  # noqa: E402
from raocp_tpu_torch import accel as port_accel  # noqa: E402
from raocp_tpu_torch.scripts import (bench_accel, bench_batch,  # noqa: E402
                                     bench_configs, bench_relax)
from raocp_tpu_torch.scripts.bench_configs import CONFIGS  # noqa: E402
from raocp_tpu_torch.solver import Solver as PortSolver  # noqa: E402

WRITE_COMMAND = ("JAX_PLATFORMS=cpu python tests/test_torch_sweeps.py "
                 "--write-reference")


def reference_runs() -> list:
    """(config name, key) of every sweep row a runner holds against the
    JAX package, each once (plain CP's key at configs 3 and 4 is shared by
    ``bench_relax``'s relax 1.0 and ``bench_accel``'s plain row)."""
    runs = [(CONFIGS[k].name, bench_relax.relax_solve(k, s))
            for k in (2, 3, 4) for s in bench_relax.SETTINGS]
    runs += [(CONFIGS[k].name, bench_accel.accel_solve(k, r))
             for k in (1, 2, 3, 4) for r in bench_accel.RUNS]
    runs += [bench_batch.batch_key(small, 8, 4000)
             for small in (False, True)]
    unique = []
    for run in runs:
        if run not in unique:
            unique.append(run)
    return unique


def _jax_problem(name):
    """(problem, x0) of a reference row's config, from the JAX package."""
    for cfg in CONFIGS.values():
        if cfg.name == name:
            return cfg.make(jax_models)
    small = name == "soc_network_small"
    return jax_models.soc_network_problem(
        **(bench_batch.SMALL if small else {}))


def jax_row(run) -> dict:
    """One reference row: the JAX package's run of (name, key) in float64
    on the CPU, as the JAX script runs it (``_run_cp``,
    ``run_cp_anderson``, ``run_cp_supermann`` from the zero start; a
    batch row's lanes as sequential ``Solver.solve`` calls)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    name, key = run
    problem, x0 = _jax_problem(name)
    solver = JaxSolver(problem, dtype=jnp.float64, offline=key["offline"])
    tic = time.perf_counter()
    row = dict(config=name, solve=key, num_nodes=problem.tree.num_nodes)
    if "lanes" in key:
        kw = {o: key[o] for o in ("max_iters", "tol", "check_every",
                                  "unroll")}
        lanes = [solver.solve(x, **kw)
                 for x in bench_batch.batch_lanes(x0, key["lanes"])]
        row.update(lane_iterations=[int(r.num_iters) for r in lanes],
                   lane_statuses=[int(r.status) for r in lanes],
                   converged=all(r.converged for r in lanes),
                   alpha=float(lanes[0].alpha))
    else:
        sp = solver.stacked
        alpha = jnp.asarray(0.999 / solver.operator_norm_sq(), sp.dtype)
        z0 = sp.zero_primal(xp=np)
        z0.x[0] = np.asarray(x0, dtype=z0.x.dtype)
        eta0 = sp.zero_dual(xp=np)
        x0j = jnp.asarray(np.asarray(x0, dtype=np.float64), sp.dtype)
        tol = jnp.asarray(key["tol"], sp.dtype)
        accel = key.get("accel")
        if accel is None:
            out = jax_run_cp(sp, z0, eta0, x0j, alpha, alpha, tol,
                             key["max_iters"],
                             check_every=key["check_every"],
                             unroll=key["unroll"], adaptive=key["adaptive"],
                             relax=key["relax"])
            t_evals = int(out[2])
        else:
            loop = getattr(jax_accel, f"run_cp_{accel}")
            out = loop(sp, tuple(z0), tuple(eta0), x0j, alpha, tol,
                       key["max_iters"], memory=key["accel_memory"],
                       check_every=key["check_every"])
            t_evals = int(out[3])
        err = np.asarray(out[-2])
        row.update(iterations=int(out[2]), t_evals=t_evals,
                   converged=bool(err.max() <= key["tol"]),
                   xi=[float(v) for v in err], alpha=float(alpha))
    row["cpu_seconds"] = time.perf_counter() - tic
    return row


def write_reference(path, jobs: int):
    """Every row of :func:`reference_runs`, ``jobs`` processes at a time
    (one XLA thread each), the longest first, into the ``sweeps`` part of
    the file (the rest of it is kept)."""
    os.environ["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    runs = sorted(reference_runs(), key=lambda r: (
        "4_" not in r[0], "accel" not in r[1], "3_" not in r[0]))
    with open(path) as fh:
        out = json.load(fh)
    out["sweeps"] = {"provenance": {
        "package": "raocp_tpu (the JAX package)", "jax": jax.__version__,
        "numpy": np.__version__,
        "platform": f"CPU, {os.cpu_count()} cores ({platform.system()} "
                    f"{platform.machine()}), {jobs} processes",
        "dtype": "float64", "command": WRITE_COMMAND}, "rows": []}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs) as pool:
        for row in pool.imap_unordered(jax_row, runs):
            print(json.dumps(row), flush=True)
            out["sweeps"]["rows"].append(row)
            with open(path, "w") as fh:
                json.dump(out, fh, indent=1)
                fh.write("\n")


# ----------------------------------------------------------------- the tests
def _jax_loop(k, key, alpha=None):
    """The JAX package's loop of config ``k`` with the reference key's
    options, as its script calls it; returns its output and the step
    size."""
    problem, x0 = CONFIGS[k].make(jax_models)
    solver = JaxSolver(problem, dtype=jnp.float64, offline=key["offline"])
    sp = solver.stacked
    if alpha is None:
        alpha = 0.999 / solver.operator_norm_sq()
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0)
    x0j = jnp.asarray(np.asarray(x0, dtype=np.float64))
    if "accel" in key:
        loop = getattr(jax_accel, f"run_cp_{key['accel']}")
        return loop(sp, tuple(z0), tuple(sp.zero_dual(xp=np)), x0j,
                    jnp.asarray(alpha), jnp.asarray(key["tol"]),
                    key["max_iters"], memory=key["accel_memory"],
                    check_every=key["check_every"]), alpha
    return jax_run_cp(sp, z0, sp.zero_dual(xp=np), x0j, alpha, alpha,
                      key["tol"], key["max_iters"],
                      check_every=key["check_every"], unroll=key["unroll"],
                      adaptive=key["adaptive"], relax=key["relax"]), alpha


@pytest.fixture(scope="module")
def accel_rows():
    return {row["run"]: row for row in bench_accel.run_accel(
        1, torch.float64, "cpu", repeats=1)}


@pytest.mark.parametrize("run", ["plain_check25_unroll25",
                                 "relax1.8_check25_unroll25"])
def test_accel_config1_plain_counts_match_jax(accel_rows, run):
    """Config 1's plain and relax-1.8 rows take the JAX package's float64
    count for the same options, and the reference's."""
    key = bench_accel.accel_solve(1, run)
    want, _ = _jax_loop(1, key)
    got = accel_rows[run]
    ref = bench_configs.reference_row(CONFIGS[1].name, key)
    assert got["converged"] and got["solve"] == key
    assert got["iterations"] == int(want[2]) == ref["iterations"] \
        == got["jax_iterations"]
    assert got["t_evals"] == got["iterations"] == ref["t_evals"]


# the windows inside which two roundings of an accelerated loop still take
# every decision alike (tests/test_torch_accel.py)
WINDOWS = {"anderson": 60, "supermann": 100}


@pytest.mark.parametrize("accel", sorted(WINDOWS))
def test_accel_config1_windows_match_jax(accel_rows, accel):
    """Anderson and SuperMann on config 1 at the JAX package's step size,
    capped inside their windows: the same iterations and T evaluations
    and iterates within 1e-8 (``test_torch_accel.py``'s bound for the
    same windows on the demo); the converged rows carry the
    reference's counts beside their own (reported, not held)."""
    run = f"{accel}_m5_check25"
    key = dict(bench_accel.accel_solve(1, run), max_iters=WINDOWS[accel],
               tol=1e-12)
    want, alpha = _jax_loop(1, key)
    problem, x0 = CONFIGS[1].make()
    psp = PortSolver(problem, offline="device", device="cpu").stacked
    z0 = psp.zero_primal()
    z0.x[0] = torch.as_tensor(x0)
    got = getattr(port_accel, f"run_cp_{accel}")(
        psp, z0, psp.zero_dual(), torch.as_tensor(x0), float(alpha), 1e-12,
        WINDOWS[accel], memory=5, check_every=25)
    assert got[2] == int(want[2]) and got[3] == int(want[3])
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-8)
    row = accel_rows[run]
    ref = bench_configs.reference_row(CONFIGS[1].name,
                                      bench_accel.accel_solve(1, run))
    assert row["converged"] and ref["converged"]
    assert (row["jax_iterations"], row["jax_t_evals"]) == \
        (ref["iterations"], ref["t_evals"])
    # the row's host reads are its accelerated loop's: a flag a period of
    # 25 iterations and two at the end
    assert row["host_reads"] == row["accel_loop_counts"]["host_reads"] \
        == -(-row["iterations"] // 25) + 2
    assert row["host_reads_per_iter"] \
        == row["host_reads"] / row["iterations"]


def test_reference_holds_every_sweep_row():
    """Every row the sweep and batch runners hold a count against is in
    the file, with its provenance; a plain CP row's T evaluations are its
    iterations, a batch row holds a count a lane."""
    sweeps = bench_configs.jax_reference()["sweeps"]
    assert sweeps["provenance"]["dtype"] == "float64"
    assert sweeps["provenance"]["command"] == WRITE_COMMAND
    for name, key in reference_runs():
        row = bench_configs.reference_row(name, key)
        assert row is not None, (name, key)
        if "lanes" in key:
            assert len(row["lane_iterations"]) == key["lanes"]
        elif "accel" not in key:
            assert row["t_evals"] == row["iterations"]
            assert row["converged"], (name, key)


if __name__ == "__main__":
    if sys.argv[1:2] != ["--write-reference"]:
        raise SystemExit(__doc__)
    write_reference(str(bench_configs._REFERENCE),
                    int(sys.argv[3]) if sys.argv[2:3] == ["--jobs"] else 7)
