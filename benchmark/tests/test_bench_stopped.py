"""The reference on a stopped Markov tree, whose nonleaf stages have
different child counts (three children a node to the stopping time, one
after it): each node's own risk rows, its kernel projection against the
dense projection onto ker [E', -I, -I] for each child count, and an
answer of the system judged; and on a tree of one child count the
reference's numbers as they were before it took stopped trees. At 40 nodes
on the CPU, float64 (3 modes, N = 5, tau = 2, n = 4, m = 2). Its dynamics
projection and adjoint: ``test_bench_harness.py``."""

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.reference import problem as bp
from benchmark.reference.cp import Reference
from benchmark.reference.judge import Judge
from benchmark.tests.conftest import TINY, TINY_STOPPED


def _config(**over):
    return dict(bp.load_config("config4_network_1e4"), dtype="float64",
                **TINY_STOPPED, **over)


def _reference(cfg=None):
    cfg = _config() if cfg is None else cfg
    return Reference(cfg, bp.plant(cfg), bp.config_tree(cfg), "cpu",
                     torch.float64)


def test_the_tree_has_two_child_counts():
    tree = bp.config_tree(_config())
    assert tree.num_nodes == 40
    assert sorted(set(tree.child_count.tolist())) == [1, 3]
    ref = _reference()
    assert ref.Y == 7 and ref.rows is not None
    assert [g[0] for g in ref.groups] == [1, 3]
    # a chain node's own rows are 3: AVaR's b = [1; 0; 1]
    chain = int(np.flatnonzero(tree.child_count == 1)[0])
    assert ref.b[chain].tolist() == [1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0]
    assert ref.rows[chain].tolist() == [True] * 3 + [False] * 4


@pytest.mark.parametrize("count", [1, 3])
def test_the_kernel_projection_is_the_dense_one(count):
    """At each node of ``count`` children, (y_i, tau_children,
    s_children) goes to its projection onto the null space of [E', -I,
    -I] (an SVD's basis); the slots after the node's own rows go to 0."""
    cfg = _config()
    tree = bp.config_tree(cfg)
    ref = _reference(cfg)
    g = torch.Generator().manual_seed(5)
    z = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_primal().items()}
    y, tau, s = ref.project_kernel(z["y"], z["tau"], z["s"])
    a = cfg["alpha"]
    c = count
    E = np.concatenate([a * np.eye(c), -np.eye(c), np.ones((1, c))])
    M = np.concatenate([E.T, -np.eye(c), -np.eye(c)], axis=1)
    _, sv, vt = np.linalg.svd(M)
    basis = vt[len(sv):].T
    nodes = np.flatnonzero(tree.child_count == c)
    assert len(nodes)
    Y = 2 * c + 1
    for i in nodes:
        kids = tree.child_first[i] + np.arange(c)
        v = np.concatenate([z["y"][i, :Y].numpy(), z["tau"][kids].numpy(),
                            z["s"][kids].numpy()])
        want = basis @ (basis.T @ v)
        got = np.concatenate([y[i, :Y].numpy(), tau[kids].numpy(),
                              s[kids].numpy()])
        assert np.abs(got - want).max() <= 1e-12
        assert not y[i, Y:].any()


def test_the_systems_answer_is_judged_by_the_stopped_reference():
    """The system solves a stopped problem to 1e-3 and the reference
    passes its answer; the same answer with its first control moved by
    0.01 fails."""
    cfg = _config()
    pl = bp.plant(cfg)
    solver = system.make_solver(system.build_problem(cfg, pl, pl.v), cfg,
                                "cpu", [])
    x0 = 0.5 * pl.x0
    res = solver.solve(x0, tol=1e-3, max_iters=20000, check_every=25)
    assert res.status == 0
    judge = Judge(cfg, 1e-3, "cpu")
    answer = dict(primal=res.primal._asdict(), dual=res.dual._asdict())
    got = judge.numbers(answer, x0)
    assert got["xi_ratio"] <= 1.5 and got["dyn_gap"] <= 1e-12
    assert got["pad"] == 0.0
    res.primal.u[0] += 0.01
    moved = judge.numbers(dict(primal=res.primal._asdict(),
                               dual=res.dual._asdict()), x0)
    assert moved["xi_ratio"] > 5.0 and moved["dyn_gap"] > 1e-5


# the reference's numbers at the tiny config 4 (one child count) before it
# took trees of several child counts, as float.hex: the step size, the
# residuals and the dynamics gap at a random point, and a plain CP solve
PARENT = {
    "config4_network_1e4": dict(
        alpha="0x1.ff7ced924c730p-3",
        res=["0x1.8100fc8bca4dcp+3", "0x1.4d6467979db12p+3",
             "0x1.57570b026d570p+3"],
        gap="0x1.4bbd943c1f9e5p+0",
        solve=[1700, ["0x1.3b272926fee02p-11", "0x1.b56d928f2f51fp-11",
                      "0x1.99d8521ea2442p-11"], "-0x1.32acc9da784b5p-2"]),
    "config3_soc_network_3k": dict(
        alpha="0x1.ff7ced924c730p-3",
        res=["0x1.802cd1283af03p+3", "0x1.4d6467979db12p+3",
             "0x1.3984a83cb907fp+3"],
        gap="0x1.4bbd943c1f9e5p+0",
        solve=[1700, ["0x1.3b37f79258300p-11", "0x1.b5b12dc3dc8a0p-11",
                      "0x1.99e038b366679p-11"], "-0x1.32acb3f83d518p-2"]),
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_one_child_count_reads_as_before_to_the_bit(name):
    cfg = dict(bp.load_config(name), dtype="float64", **TINY)
    ref = _reference(cfg)
    assert ref.rows is None
    g = torch.Generator().manual_seed(5)
    z = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_primal().items()}
    e = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_dual().items()}
    x0 = torch.linspace(-1, 1, cfg["num_states"], dtype=torch.float64)
    res = ref.residual_at(z, e, x0)
    zz, _, k, xi = ref.solve(0.5 * bp.plant(cfg).x0, 1e-3, 3000)
    got = dict(alpha=ref.step_size().hex(), res=[r.hex() for r in res],
               gap=ref.dynamics_gap(z, x0).hex(),
               solve=[k, [v.hex() for v in xi],
                      float(zz["u"][0].sum()).hex()])
    assert got == PARENT[name]
