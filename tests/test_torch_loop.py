"""The port's device loop against the loop it replaces and against JAX.

``solver._run_cp`` keeps the loop's state on the device and runs a check
period at a time: on a card a replay of a captured CUDA graph, on the CPU
(here) the same period eagerly. It must give the host loop's iterates,
count and history bit for bit (``_run_cp_host``, NaN rows included; with
and without a period enqueued ahead of the flag the host reads), and the
JAX package's ``_run_cp`` to 1e-10 in float64 (as Gate A,
``tests/test_torch_solver.py``). The inputs are made with numpy; both
packages take the JAX package's step size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.solver import _run_cp as jax_run_cp  # noqa: E402

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402

# a 15-node uniform tree: cheap JAX compiles; solved to a looser
# tolerance than the demo's, for a few hundred iterations
TINY = dict(num_states=4, num_inputs=2, num_modes=2, num_stages=3,
            stopping_time=3)
TINY_TOL = 3e-2
DEMO_TOL = 1e-3


def _pair(make):
    """(port solver, JAX solver, x0, the JAX step size) of one problem."""
    jp, x0 = make(jax_models)
    pp, _ = make(port_models)
    jsolver = rj.Solver(jp)
    alpha = 0.999 / jsolver.operator_norm_sq()
    return rt.Solver(pp, device="cpu"), jsolver, np.asarray(x0), alpha


@pytest.fixture(scope="module")
def tiny():
    return _pair(lambda m: m.random_network_problem(**TINY))


@pytest.fixture(scope="module")
def demo():
    return _pair(lambda m: m.demo_problem())


def _port_start(sp, x0, warm=None):
    x0t = torch.as_tensor(x0, dtype=sp.dtype)
    if warm is not None:
        return warm[0], warm[1], x0t
    z0 = sp.zero_primal()
    z0.x[0] = x0t
    return z0, sp.zero_dual(), x0t


def _port(solver, x0, alpha, loop, warm=None, tol=TINY_TOL, **opts):
    """``_run_cp`` through the device loop (``loop`` = the periods it
    enqueues ahead, 0 or 1) or the host loop (``loop`` = "host")."""
    sp = solver.stacked
    z0, eta0, x0t = _port_start(sp, x0, warm)
    if loop == "host":
        with solver_mod._host_loop():
            return solver_mod._run_cp(sp, z0, eta0, x0t, alpha, alpha, tol,
                                      **opts)
    real = solver_mod._lookahead
    solver_mod._lookahead = lambda device: loop
    try:
        return solver_mod._run_cp(sp, z0, eta0, x0t, alpha, alpha, tol,
                                  **opts)
    finally:
        solver_mod._lookahead = real


def _jax(jsolver, x0, alpha, warm=None, tol=TINY_TOL, **opts):
    sp = jsolver.stacked
    if warm is None:
        z0 = sp.zero_primal(xp=np)
        z0.x[0] = x0
        warm = (z0, sp.zero_dual(xp=np))
    z, eta, k, err, hist = jax_run_cp(
        sp, tuple(jnp.asarray(np.asarray(v)) for v in warm[0]),
        tuple(jnp.asarray(np.asarray(v)) for v in warm[1]), jnp.asarray(x0),
        alpha, alpha, tol, **opts)
    k = int(k)
    return (tuple(np.asarray(v) for v in z), tuple(np.asarray(v) for v in eta),
            k, np.asarray(err), np.asarray(hist)[:k])


def _assert_same(got, want):
    """Bit for bit: count, iterates, final residuals and history (NaN rows
    where the host loop has them)."""
    assert got[2] == want[2]
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4].shape == want[4].shape and got[4].dtype == want[4].dtype
    np.testing.assert_array_equal(got[4], want[4])


def _assert_jax(got, want):
    """Within 1e-10 of the JAX package's run (Gate A's bound)."""
    assert got[2] == want[2]
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-10)


def _check(pair, ahead, **opts):
    """The device loop (``ahead`` periods enqueued ahead of the flag the
    host reads) against the host loop and JAX; returns the count."""
    solver, jsolver, x0, alpha = pair
    host = _port(solver, x0, alpha, "host", **opts)
    _assert_same(_port(solver, x0, alpha, ahead, **opts), host)
    _assert_jax(host, _jax(jsolver, x0, alpha, **opts))
    return host[2]


def test_demo_937(demo):
    """The parity gate through the device loop as it runs on a card (a
    period ahead): 937 iterations in float64, the host loop's run bit for
    bit, JAX's to 1e-10."""
    assert _check(demo, 1, max_iters=2000, tol=DEMO_TOL) == 937


# name -> (the loop's options, its count: JAX's on this tree)
CASES = {
    "ce1_u1": (dict(max_iters=2000), 210),
    "ce25_u1": (dict(max_iters=2000, check_every=25), 225),
    "ce25_u5": (dict(max_iters=2000, check_every=25, unroll=5), 225),
    "ce25_u25": (dict(max_iters=2000, check_every=25, unroll=25), 225),
    # 12 rebalancing checks, then the cap (JAX converges at 725)
    "adaptive": (dict(max_iters=300, check_every=25, unroll=5,
                      adaptive=True), 300),
    "relax1.8": (dict(max_iters=2000, check_every=25, relax=1.8), 125),
    # the cap falls mid-period: two periods, then an eager tail of 11 steps
    "cap_mid_period": (dict(max_iters=60, check_every=25), 61),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_options_match_host_loop_and_jax(tiny, case):
    """Each case through the device loop on the CPU's own terms (no period
    ahead) and on the card's (one ahead), in turns over the cases."""
    opts, count = CASES[case]
    got = _check(tiny, sorted(CASES).index(case) % 2, **opts)
    if count is not None:
        assert got == count


@pytest.mark.parametrize("ahead", ["host", 0, 1])
def test_unroll_must_divide_check_every(tiny, ahead):
    """(check_every, unroll) = (1, 5) is refused, as JAX refuses it."""
    solver, jsolver, x0, alpha = tiny
    with pytest.raises(ValueError, match="unroll must divide"):
        _port(solver, x0, alpha, ahead, max_iters=100, unroll=5)
    with pytest.raises(ValueError, match="unroll must divide"):
        _jax(jsolver, x0, alpha, max_iters=100, unroll=5)


def test_warm_start_k0_and_log_lines(tiny, capfd):
    """From a warm start, with ``k0`` and ``log_every``: the device loop
    prints the host loop's lines in its order, and JAX's numbers."""
    solver, jsolver, x0, alpha = tiny
    sp = solver.stacked
    warm = _port(solver, x0, alpha, "host", max_iters=40)[:2]
    warm_np = tuple(tuple(v.numpy() for v in t) for t in warm)
    opts = dict(max_iters=200, check_every=5, unroll=5, log_every=7,
                k0=41)
    lines = {}
    for loop in ("host", 0, 1):
        got = _port(solver, x0, alpha, loop,
                    warm=tuple(type(t)(*(v.clone() for v in t))
                               for t in warm), **opts)
        lines[loop] = capfd.readouterr().out.splitlines()
        if loop == "host":
            host = got
        else:
            _assert_same(got, host)
    want = _jax(jsolver, x0, alpha, warm=warm_np, **opts)
    jax_lines = capfd.readouterr().out.splitlines()
    _assert_jax(host, want)
    assert lines["host"] == lines[0] == lines[1]
    assert len(lines["host"]) == -(-host[2] // 7)
    assert lines["host"][1].split()[2] == str(41 + 7)
    assert [ln.replace("[raocp_tpu_torch]", "") for ln in lines["host"]] \
        == [ln.replace("[raocp_tpu]", "") for ln in jax_lines]
    assert sp.dtype == torch.float64


def test_chunked_solve(tiny):
    """``chunk_iters`` drives the device loop chunk by chunk: the host
    loop's solve bit for bit, JAX's chunked solve to 1e-10."""
    solver, jsolver, x0, alpha = tiny
    opts = dict(max_iters=2000, tol=TINY_TOL, alpha=alpha, check_every=25,
                chunk_iters=60)
    got = solver.solve(x0, **opts)
    with solver_mod._host_loop():
        host = solver.solve(x0, **opts)
    want = jsolver.solve(x0, **opts)
    assert got.num_iters == host.num_iters == want.num_iters
    for name in ("xi_history", "delta_history", "xi"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(host, name))
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-10)
    for a, b, c in zip((*got.primal, *got.dual), (*host.primal, *host.dual),
                       (*want.primal, *want.dual)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=1e-10)


def test_batch_of_three_lanes(tiny, monkeypatch):
    """``solve_batch`` of three lanes through the device loop (a [B] flag
    a period, a period enqueued ahead): the host loop's lanes bit for bit,
    and JAX's per-lane counts and histories."""
    solver, jsolver, x0, alpha = tiny
    x0s = np.stack([x0, 0.5 * x0, -0.3 * x0])
    opts = dict(max_iters=2000, tol=TINY_TOL, alpha=alpha, check_every=25,
                unroll=5)
    monkeypatch.setattr(solver_mod, "_lookahead", lambda device: 1)
    got = solver.solve_batch(x0s, **opts)
    with solver_mod._host_loop():
        host = solver.solve_batch(x0s, **opts)
    want = jsolver.solve_batch(x0s, **opts)
    assert len({r.num_iters for r in want}) > 1      # lanes stop apart
    for g, h, w in zip(got, host, want):
        assert g.num_iters == h.num_iters == w.num_iters
        for name in ("xi_history", "delta_history", "xi"):
            np.testing.assert_array_equal(getattr(g, name), getattr(h, name))
            np.testing.assert_allclose(getattr(g, name), getattr(w, name),
                                       rtol=0, atol=1e-10)
        for a, b in zip((*g.primal, *g.dual), (*h.primal, *h.dual)):
            np.testing.assert_array_equal(a, b)


def test_wasted_period_and_counts(tiny):
    """One period enqueued ahead: the loop runs one period past the one
    whose flag stops it, counts it as wasted, and returns the converged
    carry; the host reads one flag a period."""
    solver, _, x0, alpha = tiny
    before = dict(solver_mod.LOOP_COUNTS)
    got = _port(solver, x0, alpha, 1, max_iters=2000, check_every=25)
    ran = {k: solver_mod.LOOP_COUNTS[k] - before[k] for k in before}
    assert got[2] == 225
    assert ran["host_reads"] == 225 // 25
    assert ran["wasted_steps"] == 25
    assert ran["steps"] == ran["periods"] * 25 == 250
    assert ran["replays"] == ran["captures"] == 0      # no graph on the CPU
