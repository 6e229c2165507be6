"""The port's batched solve (``Solver.solve_batch``) against the JAX
package's on the CPU (float64): B initial states in one loop, each lane
stopping at its own count with the JAX package's vmapped counts and
histories (the demo's lanes: the 937-iteration gate; the uniform tree's:
K1's plain version, plain, adaptive and relaxed), and the entry point's
checks. ``tests/test_torch_batch_extras.py`` holds the rest."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402

# the tests/test_pallas.py fixture: a fully uniform 121-node tree, which
# on the CPU takes K1's plain version
UNIFORM = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
               stopping_time=4)


def _lanes(x0):
    """The demo test's three lanes (tests/test_solver.py:330)."""
    x0 = np.asarray(x0, dtype=np.float64)
    return np.stack([x0, 0.5 * x0, -0.3 * x0])


@pytest.fixture(scope="module")
def jax_demo_batch():
    problem, x0 = jax_models.demo_problem()
    solver = rj.Solver(problem)
    return solver.solve_batch(_lanes(x0), max_iters=2000, tol=1e-3)


def test_demo_batch_matches_jax(jax_demo_batch):
    """The demo's three lanes (ragged tree: the torch branches): lane 0
    takes the single solve's 937 iterations and its primal to 1e-12; every
    lane takes JAX's count with its history to 1e-10 at the JAX step
    size."""
    problem, x0 = port_models.demo_problem()
    solver = rt.Solver(problem, device="cpu")
    results = solver.solve_batch(_lanes(x0), max_iters=2000, tol=1e-3,
                                 alpha=jax_demo_batch[0].alpha)
    assert [r.num_iters for r in results] \
        == [r.num_iters for r in jax_demo_batch]
    assert results[0].num_iters == 937
    assert all(r.converged for r in results)
    for got, want in zip(results, jax_demo_batch):
        np.testing.assert_allclose(got.xi_history, want.xi_history,
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.delta_history, want.delta_history,
                                   rtol=0, atol=1e-10)
        for a, b in zip(got.primal, want.primal):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
        checks = solver.validate(got)
        assert checks["dynamics"] < 1e-8 and checks["kernel"] < 1e-8
    single = solver.solve(x0, max_iters=2000, tol=1e-3,
                          alpha=jax_demo_batch[0].alpha)
    assert single.num_iters == 937
    for a, b in zip(results[0].primal, single.primal):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert results[0].alpha == single.alpha
    assert len({r.solve_time for r in results}) == 1


@pytest.fixture(scope="module")
def uniform_solvers():
    jp, x0 = jax_models.random_network_problem(**UNIFORM)
    pp, _ = port_models.random_network_problem(**UNIFORM)
    return rj.Solver(jp), rt.Solver(pp, device="cpu"), _lanes(x0)


@pytest.mark.parametrize("options", [
    {}, dict(adaptive=True), dict(relax=1.8)],
    ids=["plain", "adaptive", "relax"])
def test_uniform_tree_batch_matches_jax(uniform_solvers, options):
    """The 121-node uniform tree (K1's plain version on the CPU), three
    lanes: JAX's per-lane counts (each lane stops on its own, with its own
    steps under ``adaptive``) and primal to 1e-9."""
    jsolver, psolver, x0s = uniform_solvers
    want = jsolver.solve_batch(x0s, max_iters=20000, tol=1e-3, **options)
    got = psolver.solve_batch(x0s, max_iters=20000, tol=1e-3,
                              alpha=want[0].alpha, **options)
    assert [r.num_iters for r in got] == [r.num_iters for r in want]
    assert len({r.num_iters for r in got}) > 1       # lanes stop apart
    for g, w in zip(got, want):
        assert g.converged and g.status == w.status
        for a, b in zip(g.primal, w.primal):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        np.testing.assert_allclose(g.xi, w.xi, rtol=1e-6)


def test_solve_batch_checks_and_clears_result(monkeypatch):
    """Initial states that are not [B, n] raise; a batch clears
    ``result``; the power iteration runs once across solve and
    solve_batch."""
    calls = {"n": 0}
    real = solver_mod._power_iteration

    def counting(sp, *a, **k):
        calls["n"] += 1
        return real(sp, *a, **k)

    monkeypatch.setattr(solver_mod, "_power_iteration", counting)
    problem, x0 = port_models.lqr_binary_problem()
    solver = rt.Solver(problem, device="cpu")
    for bad in (np.asarray(x0), np.zeros((2, 3)), np.zeros((0, 2))):
        with pytest.raises(ValueError, match="initial_states"):
            solver.solve_batch(bad, max_iters=10)
    solver.solve(x0, max_iters=50, tol=1e-3)
    assert solver.result is not None
    results = solver.solve_batch(np.stack([x0, x0]), max_iters=50, tol=1e-3)
    assert solver.result is None
    with pytest.raises(RuntimeError, match="no solve result"):
        solver.validate()
    assert calls["n"] == 1
    assert results[0].num_iters == results[1].num_iters
    with pytest.raises(ValueError, match="relax"):
        solver.solve_batch(np.stack([x0, x0]), relax=2.0)
    with pytest.raises(ValueError, match="step_ratio"):
        solver.solve_batch(np.stack([x0, x0]), step_ratio=0.0)
