"""More of the port's batched solve against the JAX package on the CPU
(float64): the uniform tree's lanes under strided checks, a lane against
its own single solve, every batched op against the unbatched op lane by
lane, the batched plain sweep against the vmapped Pallas kernel in
interpret mode, K1's batched schedule and work counts, and the wrapper's
checks of the lanes. The batched kernel itself is tested on a card by
``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raocp_tpu as rj  # noqa: E402
import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
from raocp_tpu.ops.pallas_sweep import project_dynamics_pallas  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.core.variables import (Dual, Primal,  # noqa: E402
                                            tree_axpy, tree_dot,
                                            tree_inf_norm, tree_scale)
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.ops.operator import ell, ell_t  # noqa: E402
from raocp_tpu_torch.ops.prox import g_conj_projections, prox_f  # noqa: E402

# the tests/test_pallas.py fixture: a fully uniform 121-node tree, which
# on the CPU takes K1's plain version
UNIFORM = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
               stopping_time=4)


def _lanes(x0):
    """The demo test's three lanes (tests/test_solver.py:330)."""
    x0 = np.asarray(x0, dtype=np.float64)
    return np.stack([x0, 0.5 * x0, -0.3 * x0])


@pytest.fixture(scope="module")
def uniform_solvers():
    jp, x0 = jax_models.random_network_problem(**UNIFORM)
    pp, _ = port_models.random_network_problem(**UNIFORM)
    return rj.Solver(jp), rt.Solver(pp, device="cpu"), _lanes(x0)


def test_uniform_tree_batch_strided_checks_match_jax(uniform_solvers):
    """``check_every=25, unroll=25``: the loop conditions are read once a
    trip, so the lanes stop on check boundaries at JAX's counts; the
    unchecked history rows stay NaN as JAX's do."""
    jsolver, psolver, x0s = uniform_solvers
    options = dict(max_iters=20000, tol=1e-3, check_every=25, unroll=25)
    want = jsolver.solve_batch(x0s, **options)
    got = psolver.solve_batch(x0s, alpha=want[0].alpha, **options)
    assert [r.num_iters for r in got] == [r.num_iters for r in want]
    assert all(r.num_iters % 25 == 0 for r in got)
    for g, w in zip(got, want):
        assert g.converged
        for a, b in zip(g.primal, w.primal):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        assert np.array_equal(np.isnan(g.xi_history), np.isnan(w.xi_history))
        rows = ~np.isnan(w.xi_history[:, 0])
        np.testing.assert_allclose(g.xi_history[rows], w.xi_history[rows],
                                   rtol=0, atol=1e-10)


def test_batch_lane_repeats_its_single_solve():
    """A lane repeats the single solve from its initial state: the same
    count, history and primal (float64, one step size), also where the
    lane stops at the iteration cap."""
    problem, x0 = port_models.random_network_problem(**UNIFORM)
    solver = rt.Solver(problem, device="cpu")
    x0s = _lanes(x0)
    for kw in (dict(max_iters=20000, tol=1e-3), dict(max_iters=60, tol=0)):
        results = solver.solve_batch(x0s, **kw)
        for b in (1, 2):
            single = solver.solve(x0s[b], **kw)
            assert results[b].num_iters == single.num_iters
            assert results[b].status == single.status
            np.testing.assert_allclose(results[b].xi_history,
                                       single.xi_history, rtol=0, atol=1e-13)
            for a, c in zip(results[b].primal, single.primal):
                np.testing.assert_allclose(a, c, rtol=0, atol=1e-12)
    assert [r.num_iters for r in results] == [61] * 3
    assert all(r.status == 1 for r in results)


def _random_tree(sp, cls, lanes, rng):
    zero = sp.zero_primal() if cls is Primal else sp.zero_dual()
    return cls(*(torch.as_tensor(rng.standard_normal(
        (lanes,) + tuple(leaf.shape)), dtype=sp.dtype) for leaf in zero))


FAMILIES = {
    "demo": lambda: port_models.demo_problem(),
    "lqr": lambda: port_models.lqr_binary_problem(),
    "spring": lambda: port_models.mass_spring_problem(num_masses=2,
                                                      num_stages=4),
    "uniform": lambda: port_models.random_network_problem(**UNIFORM),
    "socnet": lambda: port_models.soc_network_problem(
        num_states=4, num_inputs=2, num_modes=2, num_stages=4,
        stopping_time=2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_ops_match_lane_by_lane(family):
    """L, L', prox_f (every dynamics branch: K1's plain version, the
    ragged gathers, the mode-constant and dense Riccati stacks), the dual
    projections and the tree helpers on [3, ...] iterates equal the
    unbatched ops on each lane, with a per-lane step size."""
    spec, x0 = FAMILIES[family]()
    sp = build_stacked(spec, device="cpu")
    rng = np.random.default_rng(5)
    z = _random_tree(sp, Primal, 3, rng)
    eta = _random_tree(sp, Dual, 3, rng)
    x0s = torch.as_tensor(_lanes(x0))
    alpha = torch.tensor([0.3, 0.5, 0.7], dtype=torch.float64)
    batched = (ell(sp, z), ell_t(sp, eta), prox_f(sp, z, alpha, x0s),
               g_conj_projections(sp, eta))
    norms = (tree_inf_norm(z, lanes=True), tree_dot(z, z, lanes=True))
    moved = (tree_axpy(alpha, z, z), tree_scale(alpha, eta))
    for b in range(3):
        zb = Primal(*(v[b] for v in z))
        eb = Dual(*(v[b] for v in eta))
        single = (ell(sp, zb), ell_t(sp, eb),
                  prox_f(sp, zb, alpha[b], x0s[b]),
                  g_conj_projections(sp, eb))
        for got, want in zip(batched, single):
            for g, w in zip(got, want):
                torch.testing.assert_close(g[b], w, rtol=0, atol=1e-13)
        assert norms[0][b] == tree_inf_norm(zb)
        torch.testing.assert_close(norms[1][b], tree_dot(zb, zb), rtol=1e-14,
                                   atol=0)
        for got, want in zip(moved, (tree_axpy(alpha[b], zb, zb),
                                     tree_scale(alpha[b], eb))):
            for g, w in zip(got, want):
                assert torch.equal(g[b], w)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("width,pad", [((6, 3), 8), ((7, 5), 5)])
def test_batched_sweep_matches_vmapped_pallas(width, pad, dtype, tol):
    """The batched plain sweep (x [3, np_pad, n], u [3, nl_pad, m], x0
    [3, n]) against ``jax.vmap`` of the Pallas kernel in interpret mode
    (Pallas's batching rule: a grid axis over the lanes), two widths with
    padding, and against the unbatched plain version lane by lane."""
    kwargs = dict(UNIFORM, num_states=width[0], num_inputs=width[1])
    spec, x0 = port_models.random_network_problem(**kwargs)
    tdt = getattr(torch, dtype)
    sp = build_stacked(spec, dtype=tdt, pad_multiple=pad, device="cpu")
    rng = np.random.default_rng(0)
    x_in = rng.standard_normal((3, sp.np_pad, sp.n))
    u_in = rng.standard_normal((3, sp.nl_pad, sp.m))
    x0s = _lanes(x0)
    args = tuple(torch.as_tensor(a, dtype=tdt) for a in (x_in, u_in, x0s))
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    assert sweep.LAUNCHES == before          # the CPU takes the plain version
    assert x.shape == (3, sp.np_pad, sp.n) and u.shape == (3, sp.nl_pad, sp.m)
    jspec, _ = jax_models.random_network_problem(**kwargs)
    jsp = jax_build(jspec, dtype=getattr(jnp, dtype), pad_multiple=pad)
    with jax.default_matmul_precision("float32"):
        x_pl, u_pl = jax.vmap(lambda xi, ui, x0i: project_dynamics_pallas(
            jsp, xi, ui, x0i, interpret=True))(
                *(jnp.asarray(a, jsp.dtype) for a in (x_in, u_in, x0s)))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_pl), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_pl), rtol=tol,
                               atol=tol)
    assert torch.all(x[:, sp.num_nodes:] == 0)
    assert torch.all(u[:, sp.num_nonleaf:] == 0)
    for b in range(3):
        xb, ub = sweep.project_dynamics_sweep_ref(sp, args[0][b], args[1][b],
                                                  args[2][b])
        torch.testing.assert_close(x[b], xb, rtol=0, atol=tol)
        torch.testing.assert_close(u[b], ub, rtol=0, atol=tol)


def test_batched_schedule_and_work_at_the_headline():
    """K1 at the headline (per lane 1, 3, 9, ..., 2,187 rows a stage, n=50,
    m=20, c=3) with B = 8 lanes, by hand. The apex runs a block a lane on
    the stages of at most 4 rows a lane, so the launches are the unbatched
    13; every other stage runs the 8 lanes' rows as one stage. The work is
    8 times the operations and the node bytes, and the weights once."""
    rows = tuple(3 ** k for k in range(8))
    plan = sweep.plan_sweep(rows, (3,) * 8, 50, 20, 4, 132, 8)
    assert (plan["launch_count"], plan["apex_stages"]) == (13, 2)
    apex = [la for la in plan["launches"] if la["kind"] == "apex"][0]
    assert (apex["grid"], apex["rows"], plan["lanes"]) == (8, 32, 8)
    assert plan["apex_tile"] == 3 == sweep.plan_sweep(
        rows, (3,) * 8, 50, 20, 4, 132)["apex_tile"]
    stage = {(la["direction"], la["stages"][0]): la
             for la in plan["launches"] if la["kind"] == "stage"}
    for direction in ("backward", "forward"):
        # 8 x 2,187 = 17,496 rows: ceil(132.5) = 133 rows a block, the
        # widest thread tile (8 rows) in whole rounds of tiles
        la = stage[direction, 7]
        assert la["rows"] == 17496 and la["tm"] == 8
        assert la["tiles"] == -(-17496 // la["tile"])
        assert la["grid"] == min(la["tiles"], 132)
        # 8 x 9 = 72 rows: one row a block, split K
        assert (stage[direction, 2]["rows"], stage[direction, 2]["tm"],
                stage[direction, 2]["grid"]) == (72, 1, 72)
    # one lane is the unbatched plan
    assert sweep.plan_sweep(rows, (3,) * 8, 50, 20, 4, 132, 1)["launches"] \
        == sweep.plan_sweep(rows, (3,) * 8, 50, 20, 4, 132)["launches"]
    with pytest.raises(ValueError, match="at least one lane"):
        sweep.plan_sweep(rows, (3,) * 8, 50, 20, 4, 132, 0)

    spec, _ = port_models.random_network_problem(
        num_states=3, num_inputs=2, num_modes=3, num_stages=8,
        stopping_time=8)
    sp = dataclasses.replace(build_stacked(spec, dtype=torch.float32,
                                           device="cpu"), n=50, m=20)
    work = sweep.sweep_work(sp, 8)
    assert work["flop"] == 8 * 48_800 * 3_280 == 1_280_512_000
    # per lane x, u and x0 in, x and u out: 1,115,350 elements; the
    # weights of 8 stages once: 187,200
    assert work["bytes"] == 4 * (8 * 1_115_350 + 187_200) == 36_440_000
    assert sweep.sweep_work(sp, 1) == sweep.sweep_work(sp)


def test_sweep_wrapper_checks_the_lanes():
    spec, x0 = port_models.random_network_problem(**UNIFORM)
    sp = build_stacked(spec, device="cpu")
    x = torch.zeros((3, sp.np_pad, sp.n), dtype=torch.float64)
    u = torch.zeros((3, sp.nl_pad, sp.m), dtype=torch.float64)
    x0s = torch.as_tensor(_lanes(x0))
    with pytest.raises(ValueError, match="u has shape"):
        sweep.project_dynamics_sweep(sp, x, u[:2], x0s)
    with pytest.raises(ValueError, match="x0 has shape"):
        sweep.project_dynamics_sweep(sp, x, u, x0s[0])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((3, sp.np_pad + 1, sp.n), dtype=torch.float64)
        sweep.project_dynamics_sweep(sp, wide[:, :sp.np_pad], u, x0s)
