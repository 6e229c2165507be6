"""The port's scale runners (``raocp_tpu_torch.scripts.bench_scale`` and
``bench_1e6``) against the JAX package on the CPU at a small depth, in
float64: the rows' fields, and the iterates after 50 CP steps against
JAX's ``_run_cp`` at the same step size; and K1's plan at the two trees
the runners build at full size (88,573 and 797,161 nodes), which the CPU
can plan but not run."""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.solver import Solver as JaxSolver  # noqa: E402
from raocp_tpu.solver import _power_iteration as jax_power  # noqa: E402
from raocp_tpu.solver import _run_cp as jax_run_cp  # noqa: E402
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.scripts import bench_1e6, bench_scale  # noqa: E402

# a small depth of the runners' tree family: n=6, m=3, fully branched
SMALL = dict(num_states=6, num_inputs=3)
ROW_FIELDS = ("metric", "value", "unit", "num_nodes", "tree_seconds",
              "build_seconds", "iters", "unroll", "power_iterations",
              "power_seconds", "dtype", "device", "card", "k1_launches",
              "prox_f_calls", "max_memory_allocated_mb", "ms_per_step")


def _leaves(tree):
    return {k: np.asarray(v, dtype=np.float64)
            for k, v in tree._asdict().items()}


@pytest.mark.parametrize("stages", [4, 5])
def test_run_tree_matches_jax_run_cp(stages):
    """``run_tree`` (which both runners call) at 4 and 5 stages: 50 CP
    steps at ``check_every=25, unroll=5`` from the zero start at JAX's
    step size end within 1e-10 of JAX's ``_run_cp`` leaf by leaf
    (relative to each leaf's largest entry), with JAX's residuals."""
    problem, x0 = jax_models.random_network_problem(
        **SMALL, num_modes=3, num_stages=stages, stopping_time=stages)
    sp = JaxSolver(problem, dtype=jnp.float64, offline="device").stacked
    lam, _ = jax_power(sp, rel_tol=1e-6)
    alpha = 0.999 / float(lam)
    z0 = sp.zero_primal(xp=np)
    z0.x[0] = np.asarray(x0)
    want = jax_run_cp(sp, z0, sp.zero_dual(xp=np), jnp.asarray(x0), alpha,
                      alpha, 0.0, 50, check_every=25, unroll=5)
    run = bench_scale.run_tree(stages, **SMALL, iters=50, alpha=alpha,
                               dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(run.x0, np.asarray(x0))
    z, eta, iters, err, _ = run.out
    assert iters == int(want[2]) == 50 == run.row["iters"]
    np.testing.assert_allclose(err, np.asarray(want[3]), rtol=1e-10, atol=0)
    got = {**_leaves(z), **_leaves(eta)}
    ref = {**_leaves(want[0]), **_leaves(want[1])}
    for name, v in ref.items():
        scale = max(np.abs(v).max(initial=0.0), 1e-300)
        assert np.abs(got[name] - v).max(initial=0.0) <= 1e-10 * scale, name
    assert run.row["num_nodes"] == (3 ** (stages + 1) - 1) // 2
    # the plain version on the CPU: no K1 launch, a prox_f call a step
    assert (run.row["k1_launches"], run.row["prox_f_calls"]) == (0, 50)


def test_scale_row_fields():
    """``run_tree`` with its own power iteration, best of two runs: the JAX
    script's fields and the port's (no card: no peak memory, no card
    name), one warm-up run and the timed runs counted, a host read a check
    period."""
    row = bench_scale.run_tree(4, **SMALL, iters=50, repeats=2,
                               dtype=torch.float64, device="cpu").row
    assert row["loop_host_reads"] == 1 + 2 * 2
    assert row["loop_periods"] == 5
    for key in ROW_FIELDS:
        assert key in row, key
    assert row["metric"] == "cp_iterations_per_s_121node_6state_tree"
    assert row["unit"] == "iter/s" and row["value"] > 0
    assert len(row["all_seconds"]) == 2
    assert row["seconds"] == min(row["all_seconds"])
    assert row["prox_f_calls"] == 100 and row["k1_launches"] == 0
    assert row["power_iterations"] > 2 and row["power_rel_tol"] == 1e-12
    assert row["card"] is None and row["device"] == "cpu"
    assert row["max_memory_allocated_mb"] == dict(build=None, power=None,
                                                  steps=None)
    assert row["finite"] and not row["converged"]


def test_bench_1e6_to_a_tolerance():
    """``bench_1e6``'s command line at 4 stages with ``--tol``: one solve
    to 1e-3 in float32 (converged, within the cap, on a check), the loose
    power iteration, the row printed as one JSON line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_1e6.main(["--stages", "4", "--states", "6", "--inputs", "3",
                        "--tol", "1e-3", "--device", "cpu"])
    (row,) = map(json.loads, out.getvalue().splitlines())
    for key in ROW_FIELDS:
        assert key in row, key
    assert row["converged"] and max(row["xi"]) <= 1e-3
    assert row["iters"] < bench_1e6.MAX_ITERS and row["iters"] % 25 == 0
    assert row["dtype"] == "torch.float32"
    assert row["power_rel_tol"] == 1e-6
    assert row["prox_f_calls"] == row["iters"]


@pytest.mark.parametrize("stages", [10, 12])
@pytest.mark.parametrize("esize", [4, 8])
def test_k1_plans_the_scale_trees(stages, esize):
    """K1's schedule at the runners' full trees (n=50, m=20, c=3; the
    797,161-node tree's last nonleaf stage has 177,147 rows over a
    531,441-row leaf stage): every nonleaf stage runs once each way, in
    the apex or in a launch of its own whose tiles cover its rows, on at
    most one block an SM, in the shared memory a block may use, and every
    row index fits the kernel's 32-bit row index."""
    rows = tuple(3 ** k for k in range(stages))
    plan = sweep.plan_sweep(rows, (3,) * stages, 50, 20, esize)
    apex = plan["apex_stages"]
    assert plan["launch_count"] == 2 * (stages - apex) + 1
    seen = {"backward": [], "forward": []}
    for la in plan["launches"]:
        assert la["smem"] <= sweep.MAX_SMEM
        if la["kind"] == "apex":
            assert la["stages"] == tuple(range(apex))
            continue
        (k,) = la["stages"]
        seen[la["direction"]].append(k)
        assert la["rows"] == rows[k] < 2 ** 31
        assert la["tile"] * la["tiles"] >= la["rows"]
        assert la["tile"] % la["tm"] == 0
        assert la["grid"] <= sweep.NUM_SMS
    assert seen["backward"] == list(range(stages - 1, apex - 1, -1))
    assert seen["forward"] == list(range(apex, stages))
    last = plan["launches"][-1]
    assert last["zero_ghosts"] and last["stages"] == (stages - 1,)
