"""K1 on the card: the CUDA sweep kernel against its plain torch version,
unbatched and batched (B lanes in one launch set), and against the torch
stage path; the roofline's rows at the headline; the loops' CUDA graphs
against the same loops run eagerly; the subtree partition on two gloo ranks
that
share the card; the dual-update kernel against its plain twin (the
cases of ``tests/test_torch_dual.py``), in a captured graph, in the loop
and through a solve of the headline; and the over-relaxation kernel
against its plain twin bit for bit (the cases of
``tests/test_torch_relax_kernel.py``), in a captured graph and in the
relaxed loop.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.models import random_network_problem  # noqa: E402
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.ops.prox import (project_dynamics,  # noqa: E402
                                      project_dynamics_stages)
from raocp_tpu_torch.scripts import roofline  # noqa: E402
from raocp_tpu_torch.scripts.bench_scale import tree_problem  # noqa: E402

# name -> (tree, pad_multiple): the tests/test_pallas.py fixture; a wider
# one (n=50, m=20, c=3); BASELINE config 5's width (n=100, m=40, c=3; 4
# stages, 40 nodes); the 9,841-node headline, whose 729- and 2,187-row stages
# are no multiples of their row tiles; and a width where m is no multiple of
# 4 (rows of 72 bytes, 8-byte copies) on the same tree, padded to multiples
# of 5
FIXTURES = {
    "small": (dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
                   stopping_time=4), 8),
    "wide": (dict(num_states=50, num_inputs=20, num_modes=3, num_stages=5,
                  stopping_time=5), 8),
    "config5_width": (dict(num_states=100, num_inputs=40, num_modes=3,
                           num_stages=3, stopping_time=3), 8),
    "headline": (dict(num_states=50, num_inputs=20, num_modes=3,
                      num_stages=8, stopping_time=8), 8),
    "odd_width": (dict(num_states=50, num_inputs=18, num_modes=3,
                       num_stages=8, stopping_time=8), 5),
}
# float64: summation-order noise; float32: the TPU test's tolerance at the
# small fixture, and 1e-4 for the 170- to 340-term sums over stages
TOLS = {"float64": 1e-12, "float32": 1e-4, ("small", "float32"): 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_matches_plain_version(cuda, name, dtype):
    kwargs, pad = FIXTURES[name]
    spec, x0 = random_network_problem(**kwargs)
    tdt = getattr(torch, dtype)
    sp = build_stacked(spec, dtype=tdt, pad_multiple=pad, device=cuda)
    rng = np.random.default_rng(0)
    args = tuple(torch.as_tensor(a, dtype=tdt, device=cuda) for a in (
        rng.standard_normal((sp.np_pad, sp.n)),
        rng.standard_normal((sp.nl_pad, sp.m)), x0))
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, *args)
    scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
    tol = TOLS.get((name, dtype), TOLS[dtype]) * scale
    torch.testing.assert_close(x, x_ref, rtol=0, atol=tol)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=tol)
    assert torch.all(x[sp.num_nodes:] == 0)
    assert torch.all(u[sp.num_nonleaf:] == 0)
    # prox's dispatch takes the kernel on the card, and a second apply on
    # the same buffers gives the same bits (no stale shared memory, no race
    # across the apex's barriers)
    x2, u2 = project_dynamics(sp, *args)
    assert sweep.LAUNCHES == before + 2
    assert torch.equal(x2, x) and torch.equal(u2, u)
    # the schedule the library was handed: every stage once each way, and
    # shared memory as the library itself counts it
    plan = sweep.sweep_schedule(sp)
    ns_nl = sp.num_stages - 1
    assert plan["launch_count"] == 2 * (ns_nl - plan["apex_stages"]) + 1
    lib = sweep._library()
    for la in plan["launches"]:
        if la["kind"] == "stage":
            fwd = la["direction"] == "forward"
            c = sp.stage_child[la["stages"][0]]
            cols = sweep.slab_cols(fwd, la["tile"], la["tm"], sp.n, sp.m, c)
            assert la["smem"] == lib.raocp_sweep_smem(
                int(fwd), la["tile"], la["tm"], cols, sp.n, sp.m, c,
                sweep._esize(tdt))


# the scale runners' trees (bench_scale, bench_1e6): n=50, m=20 fully
# branched for 10 and 12 stages, 88,573 and 797,161 nodes; the latter's
# 177,147 parents reach the 531,441-row leaf stage
SCALE_STAGES = {"scale_88573": 10, "tree_797161": 12}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCALE_STAGES))
def test_kernel_matches_plain_version_at_scale(cuda, name):
    """K1 on the scale runners' trees in float32 (unpadded, as their
    solver stacks them) against the plain version, to 1e-6 of the output's
    largest entry."""
    spec, x0 = tree_problem(SCALE_STAGES[name])
    sp = build_stacked(spec, dtype=torch.float32, offline="device",
                       device=cuda)
    rng = np.random.default_rng(0)
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=cuda)
                 for a in (rng.standard_normal((sp.np_pad, sp.n)),
                           rng.standard_normal((sp.nl_pad, sp.m)), x0))
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, *args)
    scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
    torch.testing.assert_close(x, x_ref, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=1e-6 * scale)
    assert torch.isfinite(x).all() and torch.isfinite(u).all()


# scripts/bench_pallas.py's four regimes (deep and narrow to wide and
# shallow) at reduced depth: 2,047, 3,280, 1,093 and 121 nodes
AB_REGIMES = {
    "deep_binary_8state": dict(num_states=8, num_inputs=3, num_modes=2,
                               num_stages=10, stopping_time=10),
    "deep_tern_16state": dict(num_states=16, num_inputs=6, num_modes=3,
                              num_stages=7, stopping_time=7),
    "headline_50state": dict(num_states=50, num_inputs=20, num_modes=3,
                             num_stages=6, stopping_time=6),
    "wide_96state": dict(num_states=96, num_inputs=32, num_modes=3,
                         num_stages=4, stopping_time=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(AB_REGIMES))
def test_kernel_matches_stage_path(cuda, name):
    """K1 against the torch stage path on the same float32 problem (up to
    300-term sums in other orders: 1e-4 of the output's largest entry);
    the stage path launches no K1, and inside ``stage_path()`` the
    dispatch is the stage path, bit for bit."""
    spec, x0 = random_network_problem(**AB_REGIMES[name])
    sp = build_stacked(spec, dtype=torch.float32, offline="device",
                       device=cuda)
    rng = np.random.default_rng(2)
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=cuda)
                 for a in (rng.standard_normal((sp.np_pad, sp.n)),
                           rng.standard_normal((sp.nl_pad, sp.m)), x0))
    before = sweep.LAUNCHES
    x, u = project_dynamics(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    xs, us = project_dynamics_stages(sp, *args)
    with sweep.stage_path():
        xd, ud = project_dynamics(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    assert torch.equal(xd, xs) and torch.equal(ud, us)
    scale = max(float(xs.abs().max()), float(us.abs().max()))
    torch.testing.assert_close(x, xs, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(u, us, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
def test_roofline_rows_at_the_headline(cuda):
    """Every row of ``scripts/roofline.py`` at the headline: finite, and
    its device time at or above its bound (a count that claims more work
    than the card did is wrong)."""
    sp, x0 = roofline.problem(8, cuda)
    rows = roofline.rows(sp, x0, applies=10, traced=5)
    assert len(rows) == 10
    for row in rows:
        assert row["launches"] > 0, row["component"]
        assert np.isfinite(row["wall_us"]) and row["bound_us"] > 0
        assert row["device_us"] >= row["bound_us"], row


@pytest.mark.cuda
@pytest.mark.parametrize("field,value", [(0, 4), (1, 0), (2, 200), (3, 2)])
def test_library_refuses_a_layout_that_does_not_fit(cuda, field, value):
    """The library computes no product's layout itself; it checks the one
    it is handed: rows of K that are not the row arrays' (Kp), no pass, more
    column groups than threads, a split where a thread owns two rows."""
    spec, x0 = random_network_problem(**FIXTURES["headline"][0])
    sp = build_stacked(spec, dtype=torch.float32, device=cuda)
    args = (torch.zeros((sp.np_pad, sp.n), device=cuda),
            torch.zeros((sp.nl_pad, sp.m), device=cuda),
            torch.as_tensor(x0, dtype=torch.float32, device=cuda))
    sweep.project_dynamics_sweep(sp, *args)
    call = sweep._problem(sp)["calls"][1]
    # the last stage's first product runs on rows of two or more a thread
    last = [la for la in call["plan"]["launches"] if la["kind"] == "stage"][0]
    assert last["tm"] > 1
    layouts = call["held"][1]
    at = 4 * 5 * last["stages"][0] + field
    kept = layouts[at]
    layouts[at] = value
    try:
        with pytest.raises(RuntimeError, match="does not take"):
            sweep.project_dynamics_sweep(sp, *args)
    finally:
        layouts[at] = kept
    sweep.project_dynamics_sweep(sp, *args)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_rejects_cpu_problem_with_cuda_tensors(cuda):
    spec, x0 = random_network_problem(**FIXTURES["small"][0])
    sp = build_stacked(spec, dtype=torch.float32, device="cpu")
    x = torch.zeros((sp.np_pad, sp.n), device=cuda)
    u = torch.zeros((sp.nl_pad, sp.m), device=cuda)
    with pytest.raises(ValueError, match="the problem on"):
        sweep.project_dynamics_sweep(
            sp, x, u, torch.as_tensor(x0, dtype=torch.float32, device=cuda))


def _lane_args(sp, x0, lanes, device, seed=1):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(x0)
    return tuple(torch.as_tensor(a, dtype=sp.dtype, device=device) for a in (
        rng.standard_normal((lanes, sp.np_pad, sp.n)),
        rng.standard_normal((lanes, sp.nl_pad, sp.m)),
        np.stack([(0.5 + 0.1 * b) * x0 for b in range(lanes)])))


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,lanes", [
    ("small", "float64", 3), ("small", "float32", 8),
    ("headline", "float32", 8), ("headline", "float64", 3),
    ("odd_width", "float32", 3)])
def test_batched_kernel_matches_plain_version(cuda, name, dtype, lanes):
    """B lanes in one launch set (one count on LAUNCHES, the apex a block
    a lane) against the batched plain version and, lane by lane, against
    the unbatched kernel (tiles of other rows: rounding apart, 1e-14 / 1e-6
    relative); ghost rows zero in every lane; a second apply
    bit-identical."""
    kwargs, pad = FIXTURES[name]
    spec, x0 = random_network_problem(**kwargs)
    tdt = getattr(torch, dtype)
    sp = build_stacked(spec, dtype=tdt, pad_multiple=pad, device=cuda)
    args = _lane_args(sp, x0, lanes, cuda)
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, *args)
    scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
    tol = TOLS.get((name, dtype), TOLS[dtype]) * scale
    torch.testing.assert_close(x, x_ref, rtol=0, atol=tol)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=tol)
    assert torch.all(x[:, sp.num_nodes:] == 0)
    assert torch.all(u[:, sp.num_nonleaf:] == 0)
    x2, u2 = sweep.project_dynamics_sweep(sp, *args)
    assert torch.equal(x2, x) and torch.equal(u2, u)
    lane_tol = {"float64": 1e-14, "float32": 1e-6}[dtype] * scale
    for b in range(lanes):
        xb, ub = sweep.project_dynamics_sweep(sp, args[0][b], args[1][b],
                                              args[2][b])
        torch.testing.assert_close(x[b], xb, rtol=0, atol=lane_tol)
        torch.testing.assert_close(u[b], ub, rtol=0, atol=lane_tol)
    plan = sweep.sweep_schedule(sp, lanes)
    apex = [la for la in plan["launches"] if la["kind"] == "apex"][0]
    assert apex["grid"] == lanes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_lane_is_the_unbatched_call(cuda, dtype):
    """A batch of one lane runs the unbatched schedule on the same tiles:
    the same bits."""
    kwargs, pad = FIXTURES["headline"]
    spec, x0 = random_network_problem(**kwargs)
    sp = build_stacked(spec, dtype=getattr(torch, dtype), pad_multiple=pad,
                       device=cuda)
    args = _lane_args(sp, x0, 1, cuda)
    x, u = sweep.project_dynamics_sweep(sp, *args)
    x1, u1 = sweep.project_dynamics_sweep(sp, args[0][0], args[1][0],
                                          args[2][0])
    assert torch.equal(x[0], x1) and torch.equal(u[0], u1)


@pytest.mark.cuda
def test_wrapper_refuses_a_wrong_lane_stride_or_shape(cuda):
    kwargs, pad = FIXTURES["small"]
    spec, x0 = random_network_problem(**kwargs)
    sp = build_stacked(spec, dtype=torch.float32, pad_multiple=pad,
                       device=cuda)
    x, u, x0s = _lane_args(sp, x0, 3, cuda)
    wide = torch.zeros((3, sp.np_pad + 2, sp.n), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.project_dynamics_sweep(sp, wide[:, :sp.np_pad], u, x0s)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.project_dynamics_sweep(
            sp, x, u, torch.zeros((3, 2 * sp.n), device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="u has shape"):
        sweep.project_dynamics_sweep(sp, x, u[:2], x0s)
    with pytest.raises(ValueError, match="x0 has shape"):
        sweep.project_dynamics_sweep(sp, x, u, x0s[:, :-1])


@pytest.mark.cuda
def test_partitioned_demo_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device) run 200 iterations of the demo in float64 partitioned: the
    single-card solve's iterates to 1e-12, and its xi history to 1e-12 of
    its largest entry (the two power iterations' step sizes differ in the
    last bits), the same on both ranks."""
    import test_torch_subtree as worker
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.models import demo_problem

    ranks = worker.run_world(2, ("cuda_demo",), str(tmp_path),
                             device_type="cuda")
    problem, x0 = demo_problem()
    single = rt.Solver(problem, dtype=torch.float64, device=cuda).solve(
        x0, max_iters=200, tol=1e-3)
    (res, arrays), (res1, arrays1) = ranks
    assert res["cuda_demo"]["device"].startswith("cuda")
    # the partition's collectives are staged on the host: its periods run
    # eagerly, none captured or replayed
    loop = res["cuda_demo"]["device_loop"]
    assert loop["captures"] == loop["replays"] == 0 < loop["periods"]
    assert res["cuda_demo"]["iters"] == single.num_iters == 201
    assert res["cuda_demo"]["alpha"] == pytest.approx(single.alpha,
                                                      rel=1e-10)
    for tree in (single.primal, single.dual):
        for k, v in tree._asdict().items():
            np.testing.assert_allclose(arrays[f"cuda_demo/{k}"], v, rtol=0,
                                       atol=1e-12, err_msg=k)
    hist = single.xi_history
    assert np.abs(arrays["cuda_demo/xi_history"] - hist).max() \
        <= 1e-12 * np.abs(hist).max()
    for k in arrays:
        np.testing.assert_array_equal(arrays1[k], arrays[k], err_msg=k)


# -- the device loop's CUDA graphs ------------------------------------------

def _loop_start(sp, x0):
    x0t = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=sp.dtype,
                          device=sp.device)
    z0 = sp.zero_primal()
    z0.x[0] = x0t
    return z0, sp.zero_dual(), x0t


@contextlib.contextmanager
def _eager():
    """In the block the loops run their periods eagerly on the card, as a
    partition's do: the capture predicate patched to false."""
    from raocp_tpu_torch.ops import cond

    real = cond.captures
    cond.captures = lambda sp: False
    try:
        yield
    finally:
        cond.captures = real


def _graph_and_eager(sp, x0, alpha, **opts):
    """``solver._run_cp`` (the graph loop) and the same loop run eagerly,
    each with the counts of what it ran."""
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.scripts.bench_configs import counted_calls

    out = {}
    for name, scope in (("graph", contextlib.nullcontext),
                        ("eager", _eager)):
        z0, eta0, x0t = _loop_start(sp, x0)
        loop = dict(solver_mod.LOOP_COUNTS)
        with scope(), counted_calls() as calls:
            got = solver_mod._run_cp(sp, z0, eta0, x0t, alpha, alpha,
                                     **opts)
            torch.cuda.synchronize()
        out[name] = got, calls, {k: v - loop[k] for k, v
                                 in solver_mod.LOOP_COUNTS.items()}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["demo_f64", "headline_f32"])
def test_graph_loop_is_the_host_loop(cuda, case):
    """The graph loop and the same loop run eagerly on the card: the same
    count, the same iterates and history bit for bit (the demo's 937 in
    float64; 200 iterations of the headline in float32 at stride 25); K1
    launches equal ``prox_f`` calls equal the steps each ran (the graph
    loop's include the period run past convergence), and both read one
    flag a period."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.models import demo_problem

    if case == "demo_f64":
        problem, x0 = demo_problem()
        solver = rt.Solver(problem, dtype=torch.float64, device=cuda)
        opts = dict(tol=1e-3, max_iters=2000)
    else:
        problem, x0 = random_network_problem(**FIXTURES["headline"][0])
        solver = rt.Solver(problem, device=cuda)
        opts = dict(tol=0.0, max_iters=200, check_every=25)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    # (steps, flags read): the demo a flag a step; the headline's 201
    # steps (the loop's cap) are 8 periods of 25 and a tail of one
    steps, flags = (937, 937) if case == "demo_f64" else (201, 8)
    for _ in range(2):                  # the capture, then replays alone
        out = _graph_and_eager(sp, x0, alpha, **opts)
        (g, g_calls, g_loop), (h, h_calls, h_loop) = out["graph"], \
            out["eager"]
        assert g[2] == h[2] == steps
        for a, b in zip((*g[0], *g[1]), (*h[0], *h[1])):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(g[3], h[3])
        np.testing.assert_array_equal(g[4], h[4])
        assert h_loop["replays"] == h_loop["captures"] == 0
        assert h_loop["host_reads"] == flags and h_loop["steps"] == steps
        assert g_loop["replays"] > 0 and g_loop["host_reads"] == flags
        assert g_loop["steps"] == steps + g_loop["wasted_steps"]
        assert g_calls["prox_f"] == g_loop["steps"]
        assert h_calls["prox_f"] == h[2]
        if sweep.sweep_eligible(sp):
            assert g_calls["k1"] == g_calls["prox_f"]
            assert h_calls["k1"] == h_calls["prox_f"]


@pytest.mark.cuda
def test_graph_loop_batch_is_the_host_loop(cuda):
    """``solve_batch`` of the demo's three lanes in float64 on the card:
    the graph loop's counts, histories and iterates are those of the same
    loop run eagerly."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.models import demo_problem

    problem, x0 = demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, device=cuda)
    x0 = np.asarray(x0)
    x0s = np.stack([x0, 0.5 * x0, -0.3 * x0])
    got = solver.solve_batch(x0s, max_iters=2000, tol=1e-3, check_every=25,
                             adaptive=True)
    with _eager():
        want = solver.solve_batch(x0s, max_iters=2000, tol=1e-3,
                                  check_every=25, adaptive=True)
    for a, b in zip(got, want):
        assert a.num_iters == b.num_iters
        np.testing.assert_array_equal(a.xi_history, b.xi_history)
        np.testing.assert_array_equal(a.delta_history, b.delta_history)
        for u, v in zip((*a.primal, *a.dual), (*b.primal, *b.dual)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_graph_loop_marks_its_replays(cuda, monkeypatch):
    """The marks of the card's clock in the graph loop's periods: 80
    replayed periods of 25 steps of the headline in float32, every one's
    flag read, are 80 timed periods; their periods and the gaps between
    them come to within 3% of the span that two events recorded on the
    stream around the drive measure; and the loop is still the eager loop
    bit for bit."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.ops import cond

    problem, x0 = random_network_problem(**FIXTURES["headline"][0])
    solver = rt.Solver(problem, device=cuda)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    # the cap's 2,000 steps: 80 periods, no tail, the last flag false
    opts = dict(tol=0.0, max_iters=1999, check_every=25)
    drive, spans = cond.drive, []

    def timed_drive(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = drive(*args, **kw)
        end.record()
        end.synchronize()
        spans.append(1e-3 * start.elapsed_time(end))
        return out

    monkeypatch.setattr(cond, "drive", timed_drive)
    _graph_and_eager(sp, x0, alpha, **opts)           # the capture
    spans.clear()
    out = _graph_and_eager(sp, x0, alpha, **opts)
    (g, _, loop), (h, _, _) = out["graph"], out["eager"]
    assert g[2] == h[2] == 2000
    for a, b in zip((*g[0], *g[1]), (*h[0], *h[1])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(g[4], h[4])
    assert loop["replays"] == loop["timed_periods"] == 80
    span, _ = spans                     # the graph loop's drive, the eager's
    marked = loop["period_device_seconds"] + loop["gap_device_seconds"]
    assert marked == pytest.approx(span, rel=0.03)
    assert 0 <= loop["gap_device_seconds"] < loop["period_device_seconds"]
    assert 0 < loop["launch_seconds"] < loop["drive_seconds"]


@pytest.mark.cuda
def test_only_capturing_loops_mark(cuda):
    """A loop that captures no graph (the power iteration's periods) holds
    no mark slot and no stamps, so it needs no mark library; one that
    captures holds both."""
    from raocp_tpu_torch.ops import cond

    running = torch.ones((), dtype=torch.bool, device=cuda)
    eager = cond.Periods(cuda, lambda: None, running, False, {})
    graphed = cond.Periods(cuda, lambda: None, running, True, {})
    assert not hasattr(eager.flags, "slot")
    assert not hasattr(eager.flags, "stamps")
    assert graphed.flags.slot.device == cuda
    assert graphed.flags.stamps.is_pinned()


@pytest.mark.cuda
def test_capture_unsafe_step_raises(cuda, tmp_path):
    """A host read patched into the CP step makes the capture fail: the
    solve raises and does not rerun eagerly. (In a process of its own: a
    failed capture may leave the card's context unusable.)"""
    import subprocess
    import sys
    import textwrap

    script = tmp_path / "unsafe.py"
    script.write_text(textwrap.dedent("""
        import torch
        import raocp_tpu_torch as rt
        from raocp_tpu_torch import solver as solver_mod
        from raocp_tpu_torch.models import demo_problem

        real = solver_mod._cp_residuals

        def reads_the_host(*args):
            err, derr = real(*args)
            float(err.max())            # a device-to-host read
            return err, derr

        solver_mod._cp_residuals = reads_the_host
        problem, x0 = demo_problem()
        solver = rt.Solver(problem, dtype=torch.float64)
        try:
            solver.solve(x0, max_iters=200, tol=1e-3, check_every=25)
        except Exception as exc:
            print("RAISED", type(exc).__name__,
                  solver_mod.LOOP_COUNTS["captures"], flush=True)
            raise SystemExit(3)
        print("RETURNED", flush=True)
    """))
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script)], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout and "RETURNED" not in proc.stdout


def _accel_runs(sp, x0, alpha, name, **opts):
    """``accel.run_cp_<name>`` through the graph loop (its first call
    captures: run twice) and the same loop run eagerly, each with its
    counts and the bodies it ran (``accel.BODY_RUNS``' growth)."""
    from raocp_tpu_torch import accel
    from raocp_tpu_torch.scripts.bench_configs import counted_calls

    out = {}
    for loop, scope in (("capture", contextlib.nullcontext),
                        ("graph", contextlib.nullcontext),
                        ("eager", _eager)):
        z0, eta0, x0t = _loop_start(sp, x0)
        bodies = dict(accel.BODY_RUNS)
        with scope(), counted_calls() as calls:
            got = getattr(accel, f"run_cp_{name}")(sp, z0, eta0, x0t, alpha,
                                                   **opts)
            torch.cuda.synchronize()
        ran = {key: accel.BODY_RUNS[key] - bodies.get(key, 0)
               for key in accel.BODY_RUNS if key[0] == name}
        calls["bodies"] = {key: n for key, n in ran.items() if n}
        out[loop] = got, calls
    return out


# name -> (problem, dtype, method, the loop's options)
ACCEL_CASES = {
    "uniform_supermann_f32": ("small", torch.float32, "supermann",
                              dict(tol=1e-12, max_iters=80)),
    "uniform_supermann_ls3_f64": ("small", torch.float64, "supermann",
                                  dict(tol=1e-12, max_iters=60, ls_max=3,
                                       check_every=5)),
    "uniform_anderson_f32": ("small", torch.float32, "anderson",
                             dict(tol=1e-4, max_iters=300, check_every=5)),
    "demo_anderson_f64": ("demo", torch.float64, "anderson",
                          dict(tol=1e-3, max_iters=2000, check_every=25)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ACCEL_CASES))
def test_graph_accel_loop_is_host_loop(cuda, case):
    """The accelerated loops' CUDA graphs (branches as conditional nodes)
    against the same loops run eagerly on the card: the same count, T
    evaluations, iterates and history bit for bit; the graph's own device
    count of each body it ran equals the eager run's (a body run untaken
    would add to it); K1 launches equal ``prox_f`` calls equal T
    evaluations (on the uniform tree, K1's); at most one host read a
    period and two at the end."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.models import demo_problem

    where, dtype, name, opts = ACCEL_CASES[case]
    if where == "demo":
        problem, x0 = demo_problem()
    else:
        problem, x0 = random_network_problem(**FIXTURES["small"][0])
    solver = rt.Solver(problem, dtype=dtype, device=cuda)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    out = _accel_runs(sp, x0, alpha, name, **opts)
    (h, h_calls) = out["eager"]
    period = 16 if opts.get("check_every", 1) == 1 else opts["check_every"]
    for loop in ("capture", "graph"):
        g, calls = out[loop]
        assert g[2] == h[2] and g[3] == h[3]
        for a, b in zip((*g[0], *g[1]), (*h[0], *h[1])):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(g[5], h[5])
        assert calls["bodies"] == h_calls["bodies"]
        assert calls["prox_f"] == calls["accel_loop"]["t_evals"] == g[3]
        if sweep.sweep_eligible(sp):
            assert calls["k1"] == calls["prox_f"]
    g_loop = out["graph"][1]["accel_loop"]
    assert g_loop["replays"] > 0 and g_loop["captures"] == 0
    assert g_loop["host_reads"] <= -(-g[2] // period) + 2
    h_loop = h_calls["accel_loop"]
    assert h_loop["replays"] == h_loop["captures"] == 0
    assert h_calls["prox_f"] == h[3]
    assert h_calls["host_reads"] == g_loop["host_reads"]


@pytest.mark.cuda
def test_untaken_bodies_do_not_run(cuda, tmp_path):
    """A profile of a graph solve of SuperMann (three line-search tries)
    on the uniform tree (its device events inside the solve's range): K1's
    kernels equal T evaluations times K1's launches per apply, so no body
    that was not taken ran (every try and the fallback hold a T
    evaluation), and the conditional nodes' set kernels equal those the
    replays ran. In a process of its own: in one that had run other traces
    and graphs the card's tracer reported kernels the bodies taken do not
    launch."""
    import json
    import os
    import subprocess
    import sys
    import textwrap

    script = tmp_path / "untaken.py"
    script.write_text(textwrap.dedent("""
        import json
        import torch
        import raocp_tpu_torch as rt
        from raocp_tpu_torch import accel
        from raocp_tpu_torch.models import random_network_problem
        from raocp_tpu_torch.ops import cond, sweep
        from raocp_tpu_torch.scripts import profile_step

        problem, x0 = random_network_problem(
            num_states=6, num_inputs=3, num_modes=3, num_stages=4,
            stopping_time=4)
        solver = rt.Solver(problem, device="cuda")
        sp = solver.stacked
        alpha = 0.999 / solver.operator_norm_sq()
        x0t = torch.as_tensor(x0, dtype=sp.dtype, device=sp.device)
        got = {}

        def solve():
            z0 = sp.zero_primal()
            z0.x[0] = x0t
            launches = cond.LAUNCHES
            got["out"] = accel.run_cp_supermann(
                sp, z0, sp.zero_dual(), x0t, alpha, 1e-12, 80, ls_max=3,
                check_every=5)
            got["sets"] = cond.LAUNCHES - launches

        solve()                                     # the capture
        events = profile_step.traced_call_events(solve)
        print(json.dumps(dict(
            iters=got["out"][2], t_evals=got["out"][3],
            sets_counted=got["sets"],
            per_apply=sweep.sweep_schedule(sp)["launch_count"],
            k1=sum(profile_step.is_k1(ev["name"]) for ev in events),
            sets=sum("set_conditional" in ev["name"] for ev in events))))
    """))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script)], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["t_evals"] > got["iters"] + 1       # tries and fallbacks ran
    assert got["k1"] == got["t_evals"] * got["per_apply"]
    assert got["sets"] == got["sets_counted"] > 0


@pytest.mark.cuda
def test_capture_unsafe_body_raises(cuda, tmp_path):
    """A host read patched into an accelerated loop's body makes its
    capture fail: the solve raises and does not rerun eagerly. (In a
    process of its own: a failed capture may leave the card's context
    unusable.)"""
    import os
    import subprocess
    import sys
    import textwrap

    script = tmp_path / "unsafe_accel.py"
    script.write_text(textwrap.dedent("""
        import torch
        import raocp_tpu_torch as rt
        from raocp_tpu_torch import accel
        from raocp_tpu_torch.models import demo_problem

        real = accel._norm

        def reads_the_host(sp, W):
            norm = real(sp, W)
            float(norm)                 # a device-to-host read
            return norm

        accel._norm = reads_the_host
        problem, x0 = demo_problem()
        solver = rt.Solver(problem, dtype=torch.float64)
        try:
            solver.solve(x0, max_iters=200, tol=1e-3, accel="anderson",
                         check_every=25)
        except Exception as exc:
            print("RAISED", type(exc).__name__,
                  accel.LOOP_COUNTS["captures"], flush=True)
            raise SystemExit(3)
        print("RETURNED", flush=True)
    """))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, str(script)], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout and "RETURNED" not in proc.stdout


@pytest.mark.cuda
def test_power_iteration_on_the_card(cuda):
    """The power iteration's device loop on the card (masked periods
    enqueued eagerly) gives the lambda and count of periods of one
    iteration (a partition's) at the headline (24 iterations), one flag
    read a period and one at the end."""
    from raocp_tpu_torch import solver as solver_mod

    problem, _ = random_network_problem(**FIXTURES["headline"][0])
    sp = build_stacked(problem, dtype=torch.float32, device=cuda)
    before = dict(solver_mod.POWER_COUNTS)
    got = solver_mod._power_iteration(sp)
    ran = {k: solver_mod.POWER_COUNTS[k] - before[k] for k in before}
    period = solver_mod.POWER_PERIOD
    solver_mod.POWER_PERIOD = 1
    try:
        assert got == solver_mod._power_iteration(sp)
    finally:
        solver_mod.POWER_PERIOD = period
    assert got[1] == 24
    assert ran["host_reads"] <= -(-got[1] // solver_mod.POWER_PERIOD) + 1


@pytest.mark.cuda
def test_accel_loop_is_freed_with_its_solver(cuda):
    """A solver's cached accelerated loops (their buffers, graphs and the
    pools of their bodies) go with the solver: ``accel._LOOPS`` keeps no
    entry of its problem and the card's allocated memory is back where it
    was before the solver (cuBLAS's workspaces, kept per stream, cleared
    at both reads)."""
    import gc

    import raocp_tpu_torch as rt
    from raocp_tpu_torch import accel

    problem, x0 = random_network_problem(**FIXTURES["small"][0])

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    def solved():
        solver = rt.Solver(problem, device=cuda)
        for method in ("anderson", "supermann"):
            res = solver.solve(x0, max_iters=60, tol=1e-12, accel=method,
                               check_every=5)
            assert res.num_iters == 61
        return solver

    first = solved()                 # the libraries, handles and streams
    del first
    start = allocated()
    solver = solved()
    key = id(solver.stacked)
    assert {(key, "anderson"), (key, "supermann")} <= set(accel._LOOPS)
    del solver
    assert allocated() == start
    assert not any(slot[0] == key for slot in accel._LOOPS)


# -- the dual-update kernel (csrc/dual.cu) -----------------------------------

# the kernel against its plain twin, relative to the largest entry of eta
# and of the twin's output. Every elementwise operation rounds as the
# twin's kernels round; the sums of a row's squares (up to 71 terms at the
# headline, 141 at config 5's width) run in another order, so float32
# outputs differ by the few ulps of a reordered sum of squares carried
# through the norm's square root and one product, and float64 by the same
# in float64
DUAL_TOLS = {"float32": 1e-6, "float64": 1e-12}
# case -> (the case of tests/test_torch_dual.py, its tree instead of the
# case's own): BASELINE config 4's 9,841 nodes at n=50, m=20 in float32
# (8-byte vectors); config 5's width (16-byte vectors); the demo in
# float64; 8 lanes with a step size each; ball and box rows beside the
# L2Ball risk's SOC block, alone and in 2 lanes; eta's parts as views at an
# odd offset and column stride 2 (one element at a time)
DUAL_CASES = {
    "headline_f32": ("small_f32", FIXTURES["headline"][0]),
    "config5_width_f32": ("small_f32", FIXTURES["config5_width"][0]),
    "demo_f64": ("demo_f64", None),
    "lanes8_f32": ("small_lanes8_f32", None),
    "mixed_f64": ("mixed_f64", None),
    "mixed_lanes2_f32": ("mixed_lanes2_f32", None),
    "strided_f64": ("strided_f64", None),
}


def _dual_case(cuda, name):
    from test_torch_dual import dual_case

    case, problem = DUAL_CASES[name]
    return dual_case(case, cuda, problem)


def _dual_scale(eta, want):
    return max([1.0] + [float(t.abs().max()) for t in (*eta, *want)
                        if t.numel()])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DUAL_CASES))
def test_dual_kernel_matches_plain_twin(cuda, name):
    """One launch gives every part of the plain twin's eta+ within
    DUAL_TOLS, in its shape and on the card; a second launch on the same
    inputs gives the same bits."""
    from raocp_tpu_torch.ops import dual

    args = _dual_case(cuda, name)
    sp, eta = args[0], args[1]
    before = dual.LAUNCHES
    got = dual.dual_update(*args)
    torch.cuda.synchronize()
    assert dual.LAUNCHES == before + 1
    want = dual.dual_update_plain(*args)
    tol = DUAL_TOLS[str(sp.dtype).split(".")[-1]] * _dual_scale(eta, want)
    for part, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, part
        torch.testing.assert_close(a, b, rtol=0, atol=tol, msg=part)
    again = dual.dual_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["headline_f32", "config5_width_f32",
                                  "mixed_f64"])
def test_dual_kernel_bits_do_not_depend_on_the_layout(cuda, name):
    """eta's parts copied one element off their alignment, so that no
    family takes vector loads, give the aligned call's bits: a thread
    takes the same entries in the same order either way."""
    from raocp_tpu_torch.core.variables import Dual
    from raocp_tpu_torch.ops import dual

    sp, eta, *rest = _dual_case(cuda, name)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    odd = Dual(*(shifted(t) for t in eta))
    plan = dual._call(sp, eta, *rest)[2]
    odd_plan = dual._call(sp, odd, *rest)[2]
    assert plan[10:16] == odd_plan[10:16] and plan[16:19] == [1, 1, 1]
    assert odd_plan[16:19] == [int(v == 1) for v in plan[10:13]]
    got, want = dual.dual_update(sp, odd, *rest), \
        dual.dual_update(sp, eta, *rest)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["headline_f32", "demo_f64", "mixed_f64"])
def test_dual_kernel_rows_do_not_depend_on_the_block(cuda, name):
    """The rows from an odd offset to the end of every node space, as a
    rank of the flat partition holds a block (a problem of its own, its
    tables cut to those rows; its inputs views at that offset, or copies),
    give the whole tree's bits on those rows: a row's eta+ depends on
    that row alone, wherever it lies."""
    import dataclasses
    from raocp_tpu_torch.core.variables import Dual
    from raocp_tpu_torch.ops import dual

    sp, eta, Lz, Lzn, alpha, shift = _dual_case(cuda, name)
    want = dual.dual_update(sp, eta, Lz, Lzn, alpha, shift)
    pads = dict(np=sp.np_pad, nl=sp.nl_pad, lf=sp.lf_pad)
    first = {space: rows // 2 + 1 for space, rows in pads.items()}
    space = dict(e1="nl", e2="nl", e3="np", e4="np", e5="np", e6="np",
                 e7="nl", e11="lf", e12="lf", e13="lf", e14="lf")
    tables = dict.fromkeys(("risk_free_rows", "risk_zero_rows",
                            "risk_soc_rows", "risk_soc_tail", "nl_lo",
                            "nl_hi", "nl_ball_c", "nl_ball_r"), "nl")
    tables.update(dict.fromkeys(("l_lo", "l_hi", "l_ball_c", "l_ball_r"),
                                "lf"))
    block = dataclasses.replace(
        sp, **{f"{s}_pad": pads[s] - first[s] for s in pads},
        **{k: None if getattr(sp, k) is None
           else getattr(sp, k)[first[s]:] for k, s in tables.items()})

    def rows(tree, copy):
        cut = (t[first[space[k]]:] for k, t in tree._asdict().items())
        return Dual(*(t.clone() if copy else t for t in cut))

    for copy in (False, True):
        got = dual.dual_update(block, rows(eta, copy), rows(Lz, copy),
                               rows(Lzn, copy), alpha, rows(shift, copy))
        assert all(torch.equal(a, b) for a, b in zip(got, rows(want, False)))


@pytest.mark.cuda
def test_dual_kernel_in_a_captured_graph(cuda):
    """Captured in a CUDA graph the call records one launch and launches
    none; each replay reads the step size that its device tensor holds
    then (changed in place between replays), and gives the eager
    kernel's bits for that step size."""
    from raocp_tpu_torch.ops import dual

    sp, eta, Lz, Lzn, alpha, shift = _dual_case(cuda, "lanes8_f32")
    dual.dual_update(sp, eta, Lz, Lzn, alpha, shift)   # the library, warm
    torch.cuda.synchronize()
    launches, recorded = dual.LAUNCHES, dual.RECORDED
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dual.dual_update(sp, eta, Lz, Lzn, alpha, shift)
    assert dual.RECORDED == recorded + 1 and dual.LAUNCHES == launches
    for scale in (1.0, 0.5, 3.0):
        alpha.mul_(scale)
        graph.replay()
        want = dual.dual_update(sp, eta, Lz, Lzn, alpha, shift)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
def test_graph_loop_counts_its_dual_launches(cuda):
    """200 steps of the headline through the graph loop (its capture, then
    replays alone) and the same loop run eagerly: one dual-update launch a
    step each, counted into ``ops.dual.LAUNCHES``; each loop's
    ``LOOP_COUNTS["dual_launches"]`` equals its steps."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.ops import dual

    problem, x0 = random_network_problem(**FIXTURES["headline"][0])
    solver = rt.Solver(problem, device=cuda)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    opts = dict(tol=0.0, max_iters=200, check_every=25)
    for _ in range(2):
        before = dual.LAUNCHES
        out = _graph_and_eager(sp, x0, alpha, **opts)
        (g, _, g_loop), (h, _, h_loop) = out["graph"], out["eager"]
        assert g[2] == h[2] == 201
        assert g_loop["dual_launches"] == g_loop["steps"] > 0
        assert h_loop["dual_launches"] == h_loop["steps"] == h[2]
        assert dual.LAUNCHES - before == g_loop["steps"] + h[2]


@pytest.mark.cuda
def test_headline_to_tolerance_through_the_dual_kernel(cuda, monkeypatch):
    """BASELINE config 4's headline to 1e-3 in float32 through the device
    loop: the kernel's count within two check periods of the plain twin's
    (the sums' order moves the last bits), both converged."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.ops import dual

    problem, x0 = random_network_problem(**FIXTURES["headline"][0])
    opts = dict(tol=1e-3, max_iters=20000, check_every=25, unroll=25)
    before = dual.LAUNCHES
    kernel = rt.Solver(problem, device=cuda).solve(x0, **opts)
    launched = dual.LAUNCHES - before
    monkeypatch.setattr(solver_mod, "dual_update", dual.dual_update_plain)
    twin = rt.Solver(problem, device=cuda).solve(x0, **opts)
    assert kernel.status == twin.status == 0
    assert abs(kernel.num_iters - twin.num_iters) <= 2 * 25
    assert launched >= kernel.num_iters


# -- the over-relaxation kernel (csrc/relax.cu) ------------------------------

# case -> (the case of tests/test_torch_relax_kernel.py, its tree instead of
# the case's own): config 5's width (n=100, m=40; 16-byte vectors) in both
# dtypes and in 8 lanes, its full 88,573 nodes in float32; a side without
# lanes read by 3; the current side one element off its allocation (no
# vectors). Every case's L z comes from ``ell`` (e3 and e4 column slices of
# one tensor, e5 the tensor of e6, e12 of e13)
RELAX_CASES = {
    "config5_width_f32": ("config5_width_f32", None),
    "config5_width_f64": ("config5_width_f64", None),
    "config5_full_f32": ("config5_width_f32", "config5"),
    "lanes8_f32": ("lanes8_f32", None),
    "lanes8_f64": ("lanes8_f64", None),
    "broadcast_f32": ("broadcast_f32", None),
    "odd_f64": ("odd_f64", None),
    "small_f32": ("small_f32", None),
}


def _relax_case(cuda, name):
    from raocp_tpu_torch.scripts.bench_configs import CONFIG5
    from test_torch_relax_kernel import relax_case

    case, problem = RELAX_CASES[name]
    return relax_case(case, cuda, CONFIG5 if problem == "config5" else None)


def _leaves(trees):
    return [v for t in trees for v in t]


def _same(got, want):
    return len(got) == len(want) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(_leaves(got), _leaves(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RELAX_CASES))
def test_relax_kernel_matches_plain_twin(cuda, name):
    """One launch gives every leaf of the plain twin's c + rho (p - c)
    (PyTorch's own kernels on the same CUDA tensors) bit for bit, in its
    shape, dtype and tree type; a second launch gives the same bits."""
    from raocp_tpu_torch.ops import relax

    rho, pairs = _relax_case(cuda, name)
    before = relax.LAUNCHES
    got = relax.over_relax(rho, pairs)
    torch.cuda.synchronize()
    assert relax.LAUNCHES == before + 1
    want = relax.over_relax_plain(rho, pairs)
    assert [type(t) for t in got] == [type(t) for t in want]
    assert all(t.is_contiguous() for t in _leaves(got))
    assert _same(got, want)
    assert _same(relax.over_relax(rho, pairs), got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config5_width_f32", "lanes8_f64",
                                  "odd_f64"])
def test_relax_kernel_bits_do_not_depend_on_the_block_split(cuda, name):
    """The pairs one a launch, in reverse order, and each leaf alone (each
    table's leaves at other blocks, other leaves beside them) give the one
    launch's bits: an entry's result depends on its c and p alone."""
    from raocp_tpu_torch.ops import relax

    rho, pairs = _relax_case(cuda, name)
    whole = relax.over_relax(rho, pairs)
    alone = tuple(relax.over_relax(rho, (pair,))[0] for pair in pairs)
    reverse = relax.over_relax(rho, pairs[::-1])[::-1]
    leaf_by_leaf = tuple(
        type(cur)(*(relax.over_relax(rho, (((c,), (p,)),))[0][0]
                    for c, p in zip(cur, new)))
        for cur, new in pairs)
    for other in (alone, reverse, leaf_by_leaf):
        assert _same(other, whole)


@pytest.mark.cuda
def test_relax_kernel_in_a_captured_graph(cuda):
    """Captured in a CUDA graph the call records one launch and launches
    none; each replay reads what its inputs hold then (changed in place
    between replays) and gives the eager kernel's bits."""
    from raocp_tpu_torch.ops import relax

    rho, pairs = _relax_case(cuda, "lanes8_f32")
    relax.over_relax(rho, pairs)                 # the library, warm
    torch.cuda.synchronize()
    launches, recorded = relax.LAUNCHES, relax.RECORDED
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = relax.over_relax(rho, pairs)
    assert relax.RECORDED == recorded + 1 and relax.LAUNCHES == launches
    for scale in (1.0, -0.5, 3.0):
        for t in {id(v): v for cur, _ in pairs for v in cur}.values():
            t.mul_(scale)
        graph.replay()
        want = relax.over_relax(rho, pairs)
        torch.cuda.synchronize()
        assert _same(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rho", [1.8, 1.0])
def test_graph_loop_counts_its_relax_launches(cuda, rho):
    """200 steps of the headline through the graph loop (its capture, then
    replays alone) and the same loop run eagerly: at relax 1.8 one
    relaxation launch a step each, counted into ``ops.relax.LAUNCHES``,
    each loop's ``LOOP_COUNTS["relax_launches"]`` equal to its steps; at
    relax 1.0 none."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.ops import relax

    problem, x0 = random_network_problem(**FIXTURES["headline"][0])
    solver = rt.Solver(problem, device=cuda)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    opts = dict(tol=0.0, max_iters=200, check_every=25, relax=rho)
    per_step = int(rho != 1.0)
    for _ in range(2):
        before = relax.LAUNCHES
        out = _graph_and_eager(sp, x0, alpha, **opts)
        (g, _, g_loop), (h, _, h_loop) = out["graph"], out["eager"]
        assert g[2] == h[2] == 201
        assert g_loop["steps"] > 0
        assert g_loop["relax_launches"] == per_step * g_loop["steps"]
        assert h_loop["relax_launches"] == per_step * h_loop["steps"] \
            == per_step * h[2]
        assert relax.LAUNCHES - before == per_step * (g_loop["steps"] + h[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["demo_f64", "headline_f32"])
def test_relaxed_loop_is_its_eager_run_and_its_twin(cuda, case,
                                                    monkeypatch):
    """A relaxed solve (rho 1.8) through the graph loop, the same loop run
    eagerly, and the graph loop with the relaxation patched to the plain
    twin: the same count, iterates and histories bit for bit (the demo to
    1e-3 in float64 at stride 1; the headline's 500 steps in float32 at
    stride 25)."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.models import demo_problem
    from raocp_tpu_torch.ops import relax

    if case == "demo_f64":
        problem, x0 = demo_problem()
        solver = rt.Solver(problem, dtype=torch.float64, device=cuda)
        opts = dict(tol=1e-3, max_iters=2000, relax=1.8)
    else:
        problem, x0 = random_network_problem(**FIXTURES["headline"][0])
        solver = rt.Solver(problem, device=cuda)
        opts = dict(tol=0.0, max_iters=500, check_every=25, relax=1.8)
    sp = solver.stacked
    alpha = 0.999 / solver.operator_norm_sq()
    out = _graph_and_eager(sp, x0, alpha, **opts)
    monkeypatch.setattr(solver_mod, "over_relax", relax.over_relax_plain)
    twin = _graph_and_eager(sp, x0, alpha, **opts)["graph"]
    g, h = out["graph"], out["eager"]
    assert g[2]["relax_launches"] > 0 and twin[2]["relax_launches"] == 0
    if case == "demo_f64":
        assert g[0][2] < 937               # relaxed: fewer than the plain 937
    for other in (h, twin):
        assert g[0][2] == other[0][2]
        for a, b in zip((*g[0][0], *g[0][1]), (*other[0][0], *other[0][1])):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(g[0][3], other[0][3])
        np.testing.assert_array_equal(g[0][4], other[0][4])
