"""The port's Chambolle-Pock solve against the JAX package's (float64):
the 937-iteration demo gate with the JAX step size (Gate A: the same xi
history to 1e-10) and with the port's own power iteration (Gate B), LQR
convergence, checkpoints that both packages read, and the options that are
not ported yet (``tests/test_torch_batch.py`` holds batch solves)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402


@pytest.fixture(scope="module")
def jax_demo():
    problem, x0 = jax_models.demo_problem()
    return rj.Solver(problem).solve(x0, max_iters=2000, tol=1e-3)


def test_gate_a_demo_matches_jax_history(jax_demo):
    """Same step size => the same iterate sequence: 937 iterations and the
    JAX xi/delta histories to 1e-10."""
    problem, x0 = port_models.demo_problem()
    res = rt.Solver(problem, device="cpu").solve(
        x0, max_iters=2000, tol=1e-3, alpha=jax_demo.alpha)
    assert res.converged and res.num_iters == jax_demo.num_iters == 937
    np.testing.assert_allclose(res.xi_history, jax_demo.xi_history,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.delta_history, jax_demo.delta_history,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.xi, [9.9508e-4, 9.4106e-4, 9.5599e-4],
                               rtol=1e-3)
    for got, want in zip(res.primal, jax_demo.primal):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert res.objective == pytest.approx(jax_demo.objective, abs=1e-10)


def test_gate_b_own_power_iteration(jax_demo):
    """The port's power iteration (NumPy-seeded start, rel_tol 1e-12) gives
    the same step size to ~1e-10 and still 937 iterations."""
    problem, x0 = port_models.demo_problem()
    solver = rt.Solver(problem, device="cpu")
    res = solver.solve(x0, max_iters=2000, tol=1e-3)
    assert res.alpha == pytest.approx(jax_demo.alpha, rel=1e-9)
    assert res.num_iters == 937 and res.converged
    assert 2 <= solver.power_iterations < 10000
    # memoised per Solver
    lam = solver.operator_norm_sq()
    assert solver.operator_norm_sq() == lam


def test_lqr_converges_and_chock():
    problem, x0 = port_models.lqr_binary_problem()
    solver = rt.Solver(problem, device="cpu")
    assert solver.chock(x0, max_iters=5000, tol=1e-4) == 0
    res = solver.result
    assert res.converged and res.xi.max() <= 1e-4
    assert res.iters_per_second > 0
    # the forward rollout leaves the dynamics exact
    tree = problem.tree
    x, u = res.primal.x, res.primal.u
    for j in range(1, tree.num_nodes):
        i = tree.ancestor_of(j)
        np.testing.assert_allclose(
            x[j], problem.state_dynamics_at_node(j) @ x[i]
            + problem.control_dynamics_at_node(j) @ u[i], atol=1e-10)


def test_not_converged_status():
    problem, x0 = port_models.demo_problem()
    res = rt.Solver(problem, device="cpu").solve(x0, max_iters=5,
                                                 tol=1e-3)
    assert res.status == 1 and res.num_iters == 6


def test_checkpoints_cross_packages(tmp_path):
    """A JAX checkpoint warm-starts the port (same continuation as JAX's
    own warm start), and the port's checkpoint parses in the JAX
    package."""
    jp, x0 = jax_models.lqr_binary_problem()
    pp, _ = port_models.lqr_binary_problem()
    jsolver = rj.Solver(jp)
    first = jsolver.solve(x0, max_iters=40, tol=1e-9)
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    z, eta, k = rt.SolverResult.load_checkpoint(path)
    assert k == first.num_iters
    jres = jsolver.solve(x0, max_iters=30, tol=1e-9, warm_start=(z, eta))
    psolver = rt.Solver(pp, device="cpu")
    pres = psolver.solve(x0, max_iters=30, tol=1e-9, alpha=first.alpha,
                         warm_start=(z, eta))
    assert pres.num_iters == jres.num_iters
    np.testing.assert_allclose(pres.xi_history, jres.xi_history,
                               rtol=0, atol=1e-10)
    out = str(tmp_path / "port.npz")
    pres.save_checkpoint(out)
    zj, ej, kj = rj.SolverResult.load_checkpoint(out)
    assert kj == pres.num_iters
    for a, b in zip(zj, pres.primal):
        np.testing.assert_array_equal(a, b)


def test_not_ported_options_raise(tmp_path):
    """Every option is ported now. Batch solves run, each lane as its
    single solve; on a real 2-rank gloo mesh (two processes on the CPU)
    ``partition="flat"`` solves, and so does a per-mode solver of an MPC
    controller on a tree with no subtree frontier (the mesh reaches it;
    "auto" takes the flat partition), both as the single device does; the
    relax / step_ratio range errors stay."""
    import test_torch_flat as flat
    from test_torch_subtree import World, _assert_iterates

    problem, x0 = port_models.lqr_binary_problem()
    solver = rt.Solver(problem, device="cpu")
    single = solver.solve(x0, max_iters=50, tol=1e-3)
    batch = solver.solve_batch(np.stack([x0, x0]), max_iters=50, tol=1e-3)
    assert [r.num_iters for r in batch] == [single.num_iters] * 2
    (got, arrays), _ = World(2, ("small",), str(tmp_path),
                             script=flat.__file__).wait()
    assert got["small"]["flat"] == [True, True]
    _assert_iterates(arrays, "lqr", solver.solve(x0, **flat.SMALL_WINDOW),
                     1e-12)
    ragged, rx0 = port_models.demo_problem(num_stages=3, stopping_time=3)
    _assert_iterates(arrays, "mpc_mode0", rt.Solver(
        ragged, device="cpu").solve(rx0, **flat.SMALL_WINDOW), 1e-12)
    with pytest.raises(ValueError, match="relax"):
        solver.solve(x0, max_iters=10, relax=2.0)
    with pytest.raises(ValueError, match="step_ratio"):
        solver.solve(x0, max_iters=10, step_ratio=0.0)


def test_solver_pins_full_float32_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    problem, _ = port_models.lqr_binary_problem()
    rt.Solver(problem, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
