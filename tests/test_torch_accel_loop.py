"""The accelerated loops and the power iteration on the device against the
JAX package.

``accel.run_cp_anderson`` / ``run_cp_supermann`` keep their state, branch
decisions and counters on the device and run a period of guarded
iterations at a time (on a card a CUDA graph replay whose branches are
conditional nodes; elsewhere, here on the CPU, the same period eagerly).
They must take the JAX loops' decisions (the count, the T evaluations and
the history's NaN rows exact, the iterates close), give the same results
bit for bit with and without a period enqueued ahead of the flag the host
reads (as a card runs them), and read the host once a period plus twice
at the end. ``solver._power_iteration`` must give JAX's lambda, and the
same lambda and count bit for bit at every period. The inputs are made
with numpy; both packages take the JAX package's step size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.accel as jax_accel  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.solver import _power_iteration as jax_power  # noqa: E402

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.accel as accel  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402

# the 121-node uniform fixture (tests/test_pallas.py's; K1's plain twin)
UNIFORM = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
               stopping_time=4)
PROBLEMS = {"demo": lambda m: m.demo_problem(),
            "uniform": lambda m: m.random_network_problem(**UNIFORM)}
METHODS = {"anderson": dict(), "supermann": dict(),
           "supermann_ls3": dict(ls_max=3)}
# the JAX windows of tests/test_torch_accel.py, where the two packages
# still take every decision alike
WINDOWS = {"anderson": 60, "supermann": 100}


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX solver, port solvers by dtype, x0, the JAX step
    size)."""
    out = {}
    for name, make in PROBLEMS.items():
        jp, x0 = make(jax_models)
        pp, _ = make(port_models)
        jsolver = rj.Solver(jp)
        alpha = 0.999 / jsolver.operator_norm_sq()
        ports = {dt: rt.Solver(pp, dtype=getattr(torch, dt), device="cpu")
                 for dt in ("float64", "float32")}
        out[name] = (jsolver, ports, np.asarray(x0), alpha)
    return out


def _run(solver, x0, alpha, method, ahead, tol, max_iters, **opts):
    """``run_cp_<method>`` with ``ahead`` periods (0 or 1) enqueued ahead
    of the flag the host reads, and the host reads it made."""
    sp = solver.stacked
    x0t = torch.as_tensor(x0, dtype=sp.dtype)
    z0 = sp.zero_primal()
    z0.x[0] = x0t
    name = "anderson" if method == "anderson" else "supermann"
    fn = getattr(accel, f"run_cp_{name}")
    opts = dict(METHODS[method], **opts)
    reads = accel.LOOP_COUNTS["host_reads"]
    real = solver_mod._lookahead
    solver_mod._lookahead = lambda sp: ahead
    try:
        out = fn(sp, z0, sp.zero_dual(), x0t, alpha, tol, max_iters, **opts)
    finally:
        solver_mod._lookahead = real
    return out, accel.LOOP_COUNTS["host_reads"] - reads


def _jax_run(jsp, x0, alpha, method, tol, max_iters, **opts):
    """The JAX package's ``run_cp_<method>`` from the zero start."""
    name = "anderson" if method == "anderson" else "supermann"
    z0 = jsp.zero_primal(xp=np)
    z0.x[0] = x0
    return getattr(jax_accel, f"run_cp_{name}")(
        jsp, z0, jsp.zero_dual(xp=np), jnp.asarray(x0), jnp.asarray(alpha),
        jnp.asarray(tol), max_iters, memory=5, **dict(METHODS[method],
                                                      **opts))


def _assert_jax(got, want, atol):
    """JAX's decisions (count, T evaluations, the history's NaN rows)
    exact; the iterates within ``atol`` (unless None), and in float64 the
    history."""
    iters = int(want[2])
    assert got[2] == iters and got[3] == int(want[3])
    hist = np.asarray(want[5])[:iters]
    np.testing.assert_array_equal(np.isnan(got[5]), np.isnan(hist))
    if atol is None:
        return
    if got[0][0].dtype == torch.float64:
        np.testing.assert_allclose(got[5], hist, rtol=0, atol=atol)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


def _assert_same(got, want):
    """Bit for bit: count, T evaluations, iterates, final residuals and
    history (NaN rows where the other run has them)."""
    assert got[2] == want[2] and got[3] == want[3]
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(got[4], dtype=np.float64),
                                  np.asarray(want[4], dtype=np.float64))
    assert got[5].shape == want[5].shape
    np.testing.assert_array_equal(got[5], want[5])


def _period(check_every):
    return accel.PERIOD_CHECK_EVERY_1 if check_every == 1 else check_every


# the capped runs' cap: 38 iterations run, the cap in mid-period at both
# strides
CAP = 37


@pytest.fixture(scope="module")
def jax_capped(pairs):
    """The JAX package's float64 runs capped at ``CAP``, one a problem,
    method and stride, made at their first use."""
    out = {}

    def run(problem, method, check_every):
        key = problem, method, check_every
        if key not in out:
            jsolver, _, x0, alpha = pairs[problem]
            out[key] = _jax_run(jsolver.stacked, x0, alpha, method, 1e-12,
                                CAP, check_every=check_every)
        return out[key]
    return run


@pytest.mark.parametrize("check_every", [1, 5])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_device_loop_is_host_loop(pairs, jax_capped, problem, dtype, method,
                                  check_every):
    """``CAP`` iterations capped, with no period and with one enqueued
    ahead: the same run bit for bit, one flag read a period and two reads
    at the end; the float64 JAX loop's decisions, and its iterates within
    the windows' bounds (float64 1e-8; SuperMann in float32 1e-4 of their
    largest entry, as ``test_supermann_float32_window_against_jax``).
    Anderson in float32 is held to the decisions alone: its least-squares
    step amplifies float32 rounding to 5.8e-4 of the largest entry of the
    uniform tree's iterates in 38 iterations (2.5e-4 against JAX's float32
    loop)."""
    _, ports, x0, alpha = pairs[problem]
    runs = [_run(ports[dtype], x0, alpha, method, ahead, 1e-12, CAP,
                 check_every=check_every) for ahead in (0, 1)]
    (got, reads), (ahead, ahead_reads) = runs
    _assert_same(ahead, got)
    assert got[2] == CAP + 1 and got[2] % _period(check_every) != 0
    assert got[3] > got[2]
    assert reads == ahead_reads == -(-got[2] // _period(check_every)) + 2
    want = jax_capped(problem, method, check_every)
    if dtype == "float64":
        atol = 1e-8
    elif method == "anderson":
        atol = None
    else:
        atol = 1e-4 * max(float(np.abs(np.asarray(b)).max())
                          for b in (*want[0], *want[1]))
    _assert_jax(got, want, atol)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_tolerance_met_in_mid_period(pairs, method):
    """The uniform tree to 5e-2 with a check every iteration: the loop
    stops inside a period of 16, and the period enqueued ahead changes
    nothing."""
    _, ports, x0, alpha = pairs["uniform"]
    want, _ = _run(ports["float64"], x0, alpha, method, 0, 5e-2, 2000)
    got, reads = _run(ports["float64"], x0, alpha, method, 1, 5e-2, 2000)
    _assert_same(got, want)
    assert got[4].max() <= 5e-2 and got[2] % accel.PERIOD_CHECK_EVERY_1
    assert reads == -(-got[2] // accel.PERIOD_CHECK_EVERY_1) + 2


def test_loop_counts(pairs):
    """``accel.LOOP_COUNTS`` counts the device loop's periods, reads,
    iterations and T evaluations (no graph on the CPU: no replay, no
    capture, no replayed T evaluation)."""
    _, ports, x0, alpha = pairs["demo"]
    before = dict(accel.LOOP_COUNTS)
    got, reads = _run(ports["float64"], x0, alpha, "supermann", 1, 1e-12, 40,
                      check_every=5)
    ran = {k: accel.LOOP_COUNTS[k] - before[k] for k in before}
    assert ran["iterations"] == got[2] == 41
    assert ran["t_evals"] == got[3]
    # 41 iterations in periods of 5; none runs ahead past the cap's last
    assert ran["periods"] == 9
    assert ran["host_reads"] == reads == 9 + 2
    assert ran["replays"] == ran["captures"] == ran["replayed_t_evals"] == 0


@pytest.fixture(scope="module")
def jax_windows(pairs):
    """The JAX package's Anderson and SuperMann runs on the demo inside
    their windows, at both strides."""
    jsolver, _, x0, alpha = pairs["demo"]
    jsp = jsolver.stacked
    return {(name, check_every): _jax_run(jsp, x0, alpha, name, 1e-12, cap,
                                          check_every=check_every)
            for name, cap in WINDOWS.items() for check_every in (1, 5)}


@pytest.mark.parametrize("ahead", [0, 1])
@pytest.mark.parametrize("check_every", [1, 5])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_loops_match_jax_in_the_window(pairs, jax_windows, name, check_every,
                                       ahead):
    """The loops inside the JAX windows (Anderson 60, SuperMann 100
    iterations, float64), with no period and with one ahead: JAX's T
    evaluations, iterates and history to 1e-8."""
    _, ports, x0, alpha = pairs["demo"]
    want = jax_windows[name, check_every]
    got, _ = _run(ports["float64"], x0, alpha, name, ahead, 1e-12,
                  WINDOWS[name], check_every=check_every)
    assert got[2] == WINDOWS[name] + 1
    _assert_jax(got, want, 1e-8)


@pytest.mark.parametrize("ls_max", [1, 3])
def test_supermann_float32_scalars(pairs, monkeypatch, ls_max):
    """SuperMann's safeguard scalars (eta_safe, r_safe, eps and the norms
    they meet) are float64 in the port's loop (``accel._SAFEGUARD``) and
    float32 in the JAX package's float32 loop. On the uniform tree in
    float32 over 150 iterations, the loop with its scalars in float32 takes
    every decision that the float64 scalars take: the same T evaluations
    and the same iterates bit for bit. Where the port parts from JAX,
    float32 rounding of the iterates parts them, not the scalars."""
    _, ports, x0, alpha = pairs["uniform"]
    want, _ = _run(ports["float32"], x0, alpha, "supermann", 0, 1e-12, 150,
                   ls_max=ls_max)
    monkeypatch.setattr(accel, "_SAFEGUARD", torch.float32)
    got, _ = _run(ports["float32"], x0, alpha, "supermann", 0, 1e-12, 150,
                  ls_max=ls_max)
    monkeypatch.undo()
    _assert_same(got, want)


def test_supermann_float32_window_against_jax(pairs):
    """The float32 window: SuperMann (``ls_max=1``) on the uniform tree,
    60 iterations at the float32 step size, with no period and with one
    ahead, against the JAX package's float32 loop: the same T evaluations
    (every decision alike) and iterates within 1e-4 of their largest entry
    (float32 rounding, amplified by the accelerated steps: 1.2e-5
    measured; the decisions part after about 80 iterations)."""
    jsolver, ports, x0, alpha = pairs["uniform"]
    a32 = float(np.float32(alpha))
    jsp = rj.Solver(jsolver.spec, dtype=jnp.float32).stacked
    z0 = jsp.zero_primal(xp=np)
    z0.x[0] = x0
    want = jax_accel.run_cp_supermann(
        jsp, z0, jsp.zero_dual(xp=np), jnp.asarray(x0, jnp.float32),
        jnp.asarray(a32, jnp.float32), jnp.asarray(1e-12, jnp.float32), 60,
        memory=5)
    leaves = [np.asarray(b) for b in (*want[0], *want[1])]
    scale = max(float(np.abs(b).max()) for b in leaves)
    for ahead in (0, 1):
        got, _ = _run(ports["float32"], x0, a32, "supermann", ahead, 1e-12,
                      60)
        assert got[2] == int(want[2]) == 61
        assert got[3] == int(want[3])
        for a, b in zip((*got[0], *got[1]), leaves):
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-4 * scale)


@pytest.mark.parametrize("period", [1, 4, 7])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_power_iteration(pairs, problem, period, monkeypatch):
    """The power iteration on the device, its periods masked (as they are
    enqueued on a card) at periods that do and do not divide the count:
    the lambda and count of periods of one iteration (a partition's)
    bit for bit (110 on the demo, 49 on the uniform tree; also capped at
    0, 1, 2 and 5 iterations), one flag read a period and one read at the
    end, and JAX's lambda to 1e-10 relative (JAX starts from other
    normals)."""
    jsolver, ports, _, _ = pairs[problem]
    sp = ports["float64"].stacked
    caps = (0, 1, 2, 5)
    monkeypatch.setattr(solver_mod, "POWER_PERIOD", 1)
    want = solver_mod._power_iteration(sp)
    capped = [solver_mod._power_iteration(sp, max_iters=cap) for cap in caps]
    monkeypatch.setattr(solver_mod, "POWER_PERIOD", period)
    before = dict(solver_mod.POWER_COUNTS)
    got = solver_mod._power_iteration(sp)
    reads = solver_mod.POWER_COUNTS["host_reads"] - before["host_reads"]
    assert got == want
    assert got[1] == {"demo": 110, "uniform": 49}[problem]
    assert reads == -(-got[1] // period) + 1
    lam_jax, _ = jax_power(jsolver.stacked)
    assert abs(got[0] - float(lam_jax)) <= 1e-10 * abs(float(lam_jax))
    for cap, w in zip(caps, capped):
        assert solver_mod._power_iteration(sp, max_iters=cap) == w


def _bodies_run(fn):
    """``fn()`` and the loops' bodies it ran (``accel.BODY_RUNS``'
    growth, every body of both kinds listed)."""
    before = dict(accel.BODY_RUNS)
    out = fn()
    return out, {(kind, name): accel.BODY_RUNS[kind, name]
                 - before.get((kind, name), 0)
                 for kind, names in accel.BODIES.items() for name in names}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_body_counts_are_the_host_loops(pairs, problem, method):
    """The device loop's own count of each body it ran (an int64 counter
    on the device that the body adds to) over 70 iterations at a stride of
    5 is the same with no period and with one enqueued ahead, and gives
    the T evaluations the loop counted."""
    _, ports, x0, alpha = pairs[problem]
    kind = "anderson" if method == "anderson" else "supermann"
    runs = {ahead: _bodies_run(lambda ahead=ahead: _run(
        ports["float64"], x0, alpha, method, ahead, 1e-12, 70,
        check_every=5)[0]) for ahead in (0, 1)}
    (want, base), (got, device) = runs[0], runs[1]
    _assert_same(got, want)
    assert device == base
    assert device[kind, "iteration"] == got[2] == 71
    assert accel._body_t_evals(kind, {name: device[kind, name] for name
                                      in accel.BODIES[kind]}) == got[3]
    # the run took more than one kind of step
    taken = [name for name in accel.BODIES[kind][1:] if device[kind, name]]
    assert len(taken) >= 2, device


@pytest.mark.parametrize("method", ["anderson", "supermann"])
def test_device_loop_keeps_no_reference_to_the_problem(pairs, method,
                                                       monkeypatch):
    """The device loop (cached per problem on a card) holds no reference
    to its problem: with the loop kept alive, the problem and its solver
    are freed (on a card the cache's entry then goes with the problem)."""
    import gc
    import weakref

    kept = []
    real = accel._loop_for

    def keeping(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(accel, "_loop_for", keeping)
    problem, x0 = port_models.demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, device="cpu")
    res = solver.solve(x0, max_iters=30, tol=1e-12, accel=method,
                       check_every=5)
    assert res.num_iters == 31 and len(kept) == 1
    gone = weakref.ref(solver.stacked)
    del solver
    gc.collect()
    assert gone() is None and kept[0].periods is not None


def test_solver_dispatch(pairs):
    """``Solver.solve(accel=...)`` runs the accelerated loop with the
    solve's options: ``run_cp_anderson``'s result bit for bit, one read a
    period plus the final two."""
    _, ports, x0, alpha = pairs["uniform"]
    solver = ports["float64"]
    opts = dict(max_iters=300, tol=2e-2, accel="anderson", alpha=alpha,
                check_every=5)
    reads = accel.LOOP_COUNTS["host_reads"]
    got = solver.solve(x0, **opts)
    reads = accel.LOOP_COUNTS["host_reads"] - reads
    want, _ = _run(solver, x0, alpha, "anderson", 0, 2e-2, 300,
                   check_every=5)
    assert got.num_iters == want[2] and got.converged
    assert reads == got.num_iters // 5 + 2
    np.testing.assert_array_equal(got.xi, want[4])
    np.testing.assert_array_equal(got.xi_history, want[5][:, :3])
    np.testing.assert_array_equal(got.delta_history, want[5][:, 3:])
    for a, b in zip((*got.primal, *got.dual), (*want[0], *want[1])):
        np.testing.assert_array_equal(a, b.numpy())
