"""The port's closed-loop MPC against the JAX package's (float64):
``demo_mpc_controller``, 3 steps from seed 0 in both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from test_torch_subtree import World  # noqa: E402

RUN = dict(num_steps=3, seed=0, max_iters=3000, tol=1e-3)


@pytest.fixture(scope="module")
def runs():
    jctl, x0 = jax_models.demo_mpc_controller()
    pctl, px0 = port_models.demo_mpc_controller(device="cpu")
    np.testing.assert_array_equal(px0, x0)
    return jctl, jctl.run(x0, **RUN), pctl, pctl.run(px0, **RUN)


def test_closed_loop_matches_jax(runs):
    """Same modes; the same iterations per step, which may be one apart
    only where the two packages' power iterations (their step sizes agree
    to ~1e-10) put a residual check on the other side of the tolerance;
    states, inputs and the total cost to 1e-8."""
    _, want, _, got = runs
    assert isinstance(got, rt.ClosedLoopResult)
    np.testing.assert_array_equal(got.modes, want.modes)
    assert np.abs(got.iterations - want.iterations).max() <= 1
    np.testing.assert_array_equal(got.statuses, want.statuses)
    assert got.converged and got.num_steps == 3
    np.testing.assert_allclose(got.states, want.states, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.inputs, want.inputs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.stage_costs, want.stage_costs, rtol=0,
                               atol=1e-8)
    assert got.total_cost == pytest.approx(want.total_cost, abs=1e-8)


def test_solver_cached_per_mode(runs):
    _, want, pctl, got = runs
    visited = set(int(w) for w in got.modes[:-1])
    solvers = {w: pctl.solver_for_mode(w) for w in visited}
    for w in visited:
        assert pctl.solver_for_mode(w) is solvers[w]
        solver, problem = solvers[w]
        assert isinstance(solver, rt.Solver)
        np.testing.assert_allclose(problem.tree.probability_of_node(
            problem.tree.children_of(0)).sum(), 1.0)
    assert len({id(s) for s in solvers.values()}) == len(visited)


def test_mesh_is_not_ported(tmp_path):
    """The mesh reaches every per-mode solver (the partitioned closed loop
    on a uniform tree is in tests/test_torch_subtree.py). On a tree with
    no subtree frontier, over a real 2-rank gloo mesh (two processes on
    the CPU), every per-mode solver takes the flat node partition and the
    closed loop matches the single-device controller's modes, counts,
    states and inputs (tests/test_torch_flat.py's ``mpc`` check)."""
    import test_torch_flat as flat

    (got, arrays), _ = World(2, ("mpc",), str(tmp_path),
                             script=flat.__file__).wait()
    ctl, x0 = port_models.demo_mpc_controller(device="cpu", **flat.RAGGED)
    want = ctl.run(x0, **flat.MPC_RUN)
    got = got["mpc"]
    assert got["flat"]
    assert got["modes"] == want.modes.tolist()
    assert got["iterations"] == want.iterations.tolist()
    np.testing.assert_allclose(arrays["mpc/states"], want.states, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(arrays["mpc/inputs"], want.inputs, rtol=0,
                               atol=1e-12)
