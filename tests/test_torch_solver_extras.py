"""The rest of the port's solver against the JAX package's (float64):
chunked solves and their elastic recovery, ``log_every``, ``profile_dir``,
``validate``, the pgfplots exports, and ``flat_linops``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu.utils.plots as jax_plots  # noqa: E402
from raocp_tpu.ops.operator import flat_linops as jax_flat  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402
from raocp_tpu_torch.ops.operator import flat_linops  # noqa: E402
from raocp_tpu_torch.ops.sweep import DeviceFault  # noqa: E402


@pytest.fixture(scope="module")
def demo():
    jp, x0 = jax_models.demo_problem()
    jsolver = rj.Solver(jp)
    jres = jsolver.solve(x0, max_iters=2000, tol=1e-3)
    pp, _ = port_models.demo_problem()
    psolver = rt.Solver(pp, device="cpu")
    pres = psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=jres.alpha)
    return jsolver, jres, psolver, pres, x0


def test_chunked_solve_equals_plain(demo):
    """A 300-iteration chunk runs 301 steps; the chunks give the plain
    solve's 937 iterations, history and iterates."""
    _, _, psolver, plain, x0 = demo
    res = psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=plain.alpha,
                        chunk_iters=300)
    assert res.converged and res.num_iters == plain.num_iters == 937
    np.testing.assert_allclose(res.xi_history, plain.xi_history, rtol=0,
                               atol=1e-12)
    for a, b in zip(res.primal, plain.primal):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def _faulty(monkeypatch, fail_on, exc=DeviceFault):
    """Make the calls of ``_run_cp`` whose 1-based index ``fail_on``
    accepts raise ``exc``; returns the call counter."""
    real = solver_mod._run_cp
    calls = {"n": 0}

    def run(*args, **kwargs):
        calls["n"] += 1
        if fail_on(calls["n"]):
            raise exc("injected device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(solver_mod, "_run_cp", run)
    return calls


@pytest.mark.parametrize("fail_on", [2, 1], ids=["second", "first"])
def test_chunk_fault_is_retried(demo, monkeypatch, fail_on):
    """One fault in a chunk: that chunk reruns from the last host snapshot
    and the solve ends as the plain one does."""
    _, _, psolver, plain, x0 = demo
    calls = _faulty(monkeypatch, lambda n: n == fail_on)
    res = psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=plain.alpha,
                        chunk_iters=300)
    assert calls["n"] == 5                      # 4 chunks, one retried
    assert res.converged and res.num_iters == plain.num_iters
    np.testing.assert_allclose(res.xi_history, plain.xi_history, rtol=0,
                               atol=1e-12)
    for a, b in zip(res.primal, plain.primal):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_persistent_fault_writes_checkpoint(demo, monkeypatch, tmp_path):
    """Every chunk after the first faults: the retry fails too, the
    checkpoint of the first chunk (k = 301) is written and resumes through
    warm_start."""
    _, _, psolver, plain, x0 = demo
    _faulty(monkeypatch, lambda n: n >= 2)
    ckpt = str(tmp_path / "fault.npz")
    with pytest.raises(RuntimeError, match="saved to") as info:
        psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=plain.alpha,
                      chunk_iters=300, checkpoint_on_fault=ckpt)
    assert isinstance(info.value.__cause__, DeviceFault)
    z, eta, k = rt.SolverResult.load_checkpoint(ckpt)
    assert k == 301
    monkeypatch.undo()
    resumed = psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=plain.alpha,
                            warm_start=(z, eta))
    assert resumed.converged
    assert resumed.num_iters + k <= plain.num_iters + 2


def test_caller_errors_are_not_retried(demo, monkeypatch):
    _, _, psolver, plain, x0 = demo
    calls = _faulty(monkeypatch, lambda n: True, exc=ValueError)
    with pytest.raises(ValueError):
        psolver.solve(x0, max_iters=2000, tol=1e-3, alpha=plain.alpha,
                      chunk_iters=300)
    assert calls["n"] == 1


def _log_lines(text):
    return [line.split("] ", 1)[1] for line in text.splitlines()
            if line.startswith("[raocp_tpu")]


@pytest.mark.parametrize("chunk_iters", [None, 300])
def test_log_every_matches_jax(demo, capsys, chunk_iters):
    """The same lines at the same (global, under chunking) indices."""
    jsolver, jres, psolver, _, x0 = demo
    kw = dict(max_iters=2000, tol=1e-3, log_every=100, check_every=5,
              chunk_iters=chunk_iters)
    capsys.readouterr()
    jsolver.solve(x0, **kw)
    want = _log_lines(capsys.readouterr().out)
    psolver.solve(x0, alpha=jres.alpha, **kw)
    got = _log_lines(capsys.readouterr().out)
    assert len(want) >= 9
    assert got == want


def test_profile_dir_writes_trace(demo, tmp_path):
    _, _, psolver, plain, x0 = demo
    out = tmp_path / "prof"
    res = psolver.solve(x0, max_iters=5, tol=1e-3, alpha=plain.alpha,
                        profile_dir=str(out))
    assert res.num_iters == 6
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert os.path.getsize(out / "trace.json") > 0


def test_validate_matches_jax(demo):
    jsolver, jres, psolver, pres, _ = demo
    want = jsolver.validate(jres)
    got = psolver.validate(pres)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
    # the last result by default
    assert psolver.validate() == psolver.validate(psolver.result)
    # the JAX result through the port's validate
    same = psolver.validate(jres)
    for key in want:
        assert same[key] == pytest.approx(want[key], abs=1e-12), key


def test_validate_flags_an_infeasible_point(demo):
    _, _, psolver, pres, _ = demo
    bad_x = pres.primal.x.copy()
    bad_x[5] += 1.0                       # breaks the dynamics at node 5
    bad_u = pres.primal.u.copy()
    bad_u[0, 0] = 0.6                     # input box is [-0.1, 0.1]
    bad = type(pres)(**{**pres.__dict__,
                        "primal": pres.primal._replace(x=bad_x, u=bad_u)})
    v = psolver.validate(bad)
    assert v["dynamics"] >= 0.99
    assert v["constraints"] == pytest.approx(0.5, abs=1e-6)
    with pytest.raises(RuntimeError, match="no solve result"):
        rt.Solver(port_models.lqr_binary_problem()[0],
                  device="cpu").validate()


def test_tex_exports_match_jax(demo, tmp_path):
    """The port's writers give the JAX package's text for the same
    result (the solver's last)."""
    jsolver, _, psolver, _, _ = demo
    pres = psolver.result
    for kind in ("residuals", "solution"):
        mine, theirs = tmp_path / f"p_{kind}.tex", tmp_path / f"j_{kind}.tex"
        getattr(psolver, f"save_{kind}_tex")(str(mine))
        if kind == "residuals":
            jax_plots.save_residuals_tex(pres, str(theirs))
        else:
            jax_plots.save_solution_tex(jsolver.spec.tree, pres, str(theirs))
        assert mine.read_text() == theirs.read_text()
    assert "\\addplot" in mine.read_text()


def test_print_states_and_inputs(demo, capsys):
    _, _, psolver, _, _ = demo
    pres = psolver.result
    psolver.print_states()
    psolver.print_inputs()
    out = capsys.readouterr().out
    assert out.startswith("states =") and "inputs =" in out
    assert out.count("]]") == len(pres.primal.x) + len(pres.primal.u)


def test_flat_linops_adjoint_and_jax(demo):
    jsolver, _, psolver, _, _ = demo
    mv, rmv, n_p, n_d = flat_linops(psolver.stacked)
    jmv, jrmv, jn_p, jn_d = jax_flat(jsolver.stacked)
    assert (n_p, n_d) == (jn_p, jn_d)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n_p)
    y = rng.standard_normal(n_d)
    # zero the padded/ghost coordinates the operators never touch
    x = rmv(mv(x))
    y = mv(rmv(y))
    assert np.dot(mv(x), y) == pytest.approx(np.dot(x, rmv(y)), rel=1e-12)
    np.testing.assert_allclose(mv(x), np.asarray(jmv(x)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rmv(y), np.asarray(jrmv(y)), rtol=0,
                               atol=1e-10)


def test_plots_write_files(demo, tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    _, _, psolver, _, _ = demo
    for kind in ("residuals", "solution"):
        path = tmp_path / f"{kind}.png"
        fig = getattr(psolver, f"plot_{kind}")(filename=str(path), show=False)
        assert path.stat().st_size > 0 and fig is not None
