"""The port's examples (``raocp_tpu_torch.examples``) against the JAX
package's on the CPU, in float64: the demo's 937 iterations and residuals,
three closed-loop MPC steps, and four risks of the risk spectrum."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu as jr  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.utils.evaluate import risk_value as jax_risk_value  # noqa
from raocp_tpu_torch.examples import (closed_loop_mpc, main,  # noqa: E402
                                      risk_spectrum)


def test_main_gives_the_demos_937(tmp_path, monkeypatch):
    """``examples.main``: 937 iterations and the residuals of the JAX
    package's demo solve, and the two plots where matplotlib is
    installed."""
    monkeypatch.chdir(tmp_path)
    got = main.main(device="cpu")
    problem, x0 = jax_models.demo_problem()
    want = jr.Solver(problem).solve(x0, max_iters=2000, tol=1e-3)
    assert got["status"] == 0
    assert got["iterations"] == int(want.num_iters) == 937
    np.testing.assert_allclose(got["xi"], np.asarray(want.xi), rtol=1e-9,
                               atol=0)
    assert got["objective"] == pytest.approx(float(want.objective),
                                             rel=1e-9, abs=0)
    pytest.importorskip("matplotlib")
    assert (tmp_path / "residuals.png").stat().st_size > 0
    assert (tmp_path / "solution.png").stat().st_size > 0


def test_closed_loop_mpc_matches_jax():
    """``examples.closed_loop_mpc`` over 3 steps: the JAX example's modes,
    counts a step and total cost (within 1e-9 relative)."""
    got = closed_loop_mpc.main(num_steps=3, device="cpu")
    controller, x0 = jax_models.demo_mpc_controller()
    want = controller.run(x0, num_steps=3, initial_mode=1, seed=0,
                          max_iters=3000, tol=1e-3)
    assert got["converged"] and bool(want.converged)
    assert got["modes"] == want.modes.tolist()
    assert got["iterations"] == want.iterations.tolist()
    assert got["total_cost"] == pytest.approx(want.total_cost, rel=1e-9,
                                              abs=0)
    np.testing.assert_allclose(got["states"], want.states, rtol=0,
                               atol=1e-8)


# four risks of the spectrum: expectation, mild, the demo's own and the
# worst case (the script runs all fourteen)
SPECTRUM = {"AVaR(1.0)": lambda: jr.AVaR(1.0),
            "MSD(0.5)": lambda: jr.MeanUpperSemideviation(0.5),
            "AVaR(0.95)": lambda: jr.AVaR(0.95),
            "AVaR(0.0)": lambda: jr.AVaR(0.0)}


@pytest.mark.parametrize("name", sorted(SPECTRUM))
def test_risk_spectrum_matches_jax(name):
    """``examples.risk_spectrum`` on one of four of its risks: the JAX
    example's count, its objective within 1e-8 relative, and the
    recursion's value of the trajectory (``utils.evaluate.risk_value``)
    equal to JAX's."""
    risks = [(label, risk) for label, risk in risk_spectrum.RISKS
             if label.split()[-1] == name]
    assert len(risks) == 1
    (row,) = risk_spectrum.main(device="cpu", risks=risks)
    problem, x0 = jax_models.demo_problem(risk=SPECTRUM[name]())
    want = jr.Solver(problem).solve(x0, max_iters=20000, tol=1e-4)
    assert row["converged"] and bool(want.converged)
    assert row["iterations"] == int(want.num_iters)
    assert row["objective"] == pytest.approx(float(want.objective),
                                             rel=1e-8, abs=0)
    v0 = jax_risk_value(problem, want.primal.x, want.primal.u)
    assert row["recursion"] == pytest.approx(v0, rel=1e-8, abs=0)
