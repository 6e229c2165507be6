"""The port's loop options against the JAX package's on the demo (float64,
the JAX step size): ``check_every``, ``relax``, ``step_ratio`` and
``adaptive`` give the same iteration counts and residual histories."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402

OPTIONS = {
    "check_every_25": dict(check_every=25),
    "check_every_25_unroll_5": dict(check_every=25, unroll=5),
    "relax_1.8": dict(relax=1.8),
    "step_ratio_2": dict(step_ratio=2.0),
    "adaptive_check_every_25": dict(adaptive=True, check_every=25),
}


@pytest.fixture(scope="module")
def solvers():
    jp, x0 = jax_models.demo_problem()
    pp, _ = port_models.demo_problem()
    jsolver = rj.Solver(jp)
    return jsolver, rt.Solver(pp, device="cpu"), x0, 0.999 / jsolver.operator_norm_sq()


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_matches_jax(solvers, name):
    jsolver, psolver, x0, alpha = solvers
    kw = dict(max_iters=5000, tol=1e-3, alpha=alpha, **OPTIONS[name])
    want = jsolver.solve(x0, **kw)
    got = psolver.solve(x0, **kw)
    assert want.converged and got.converged
    assert got.num_iters == want.num_iters
    nan_got = np.isnan(got.xi_history)
    assert np.array_equal(nan_got, np.isnan(want.xi_history))
    np.testing.assert_allclose(got.xi_history[~nan_got],
                               want.xi_history[~nan_got], rtol=0, atol=1e-9)
    if "check_every" in OPTIONS[name]:
        assert got.num_iters % OPTIONS[name]["check_every"] == 0
