"""K1 on the card: the CUDA sweep kernel against its plain torch version,
unbatched and batched (B lanes in one launch set), and against the torch
stage path; the roofline's rows at the headline; the CP loop's CUDA graphs
against the host loop; and the subtree partition on two gloo ranks that
share the card.

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
    # the partition's collectives are staged on the host: its host loop
    assert res["cuda_demo"]["device_loop_periods"] == 0
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


def _graph_and_host(sp, x0, alpha, **opts):
    """``solver._run_cp`` (the graph loop) and the same under
    ``_host_loop()``, each with the counts of what it ran."""
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.scripts.bench_configs import counted_calls

    out = {}
    for name, scope in (("graph", None), ("host", solver_mod._host_loop)):
        z0, eta0, x0t = _loop_start(sp, x0)
        loop = dict(solver_mod.LOOP_COUNTS)
        with scope() if scope else contextlib.nullcontext(), \
                counted_calls() as calls:
            got = solver_mod._run_cp(sp, z0, eta0, x0t, alpha, alpha,
                                     **opts)
            torch.cuda.synchronize()
        out[name] = got, calls, {k: v - loop[k] for k, v
                                 in solver_mod.LOOP_COUNTS.items()}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["demo_f64", "headline_f32"])
def test_graph_loop_is_the_host_loop(cuda, case):
    """The graph loop and the host loop on the card: the same count, the
    same iterates and history bit for bit (the demo's 937 in float64; 200
    iterations of the headline in float32 at stride 25); K1 launches equal
    ``prox_f`` calls equal the steps each ran (the graph loop's include
    the period run past convergence), and the graph loop read one flag a
    period."""
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
        out = _graph_and_host(sp, x0, alpha, **opts)
        (g, g_calls, g_loop), (h, h_calls, h_loop) = out["graph"], \
            out["host"]
        assert g[2] == h[2] == steps
        for a, b in zip((*g[0], *g[1]), (*h[0], *h[1])):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(g[3], h[3])
        np.testing.assert_array_equal(g[4], h[4])
        assert h_loop["periods"] == 0
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
    the graph loop's counts, histories and iterates are the host loop's."""
    import raocp_tpu_torch as rt
    from raocp_tpu_torch import solver as solver_mod
    from raocp_tpu_torch.models import demo_problem

    problem, x0 = demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, device=cuda)
    x0 = np.asarray(x0)
    x0s = np.stack([x0, 0.5 * x0, -0.3 * x0])
    got = solver.solve_batch(x0s, max_iters=2000, tol=1e-3, check_every=25,
                             adaptive=True)
    with solver_mod._host_loop():
        want = solver.solve_batch(x0s, max_iters=2000, tol=1e-3,
                                  check_every=25, adaptive=True)
    for a, b in zip(got, want):
        assert a.num_iters == b.num_iters
        np.testing.assert_array_equal(a.xi_history, b.xi_history)
        np.testing.assert_array_equal(a.delta_history, b.delta_history)
        for u, v in zip((*a.primal, *a.dual), (*b.primal, *b.dual)):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
def test_capture_unsafe_step_raises(cuda, tmp_path):
    """A host read patched into the CP step makes the capture fail: the
    solve raises and does not rerun on the host loop. (In a process of its
    own: a failed capture may leave the card's context unusable.)"""
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
