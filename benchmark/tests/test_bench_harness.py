"""The harness: every name resolves to its files, a new cell is found from
its JSON alone, the inputs repeat for a seed, nothing forbidden is loaded,
the reference is sound, and a run whose timed path is broken comes out
not correct. The runs here are at a CPU's size (40 nodes); the last test
runs a cell on a card."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run as bench
from benchmark.reference import problem as bp
from benchmark.reference.cp import Reference
from benchmark.tests.conftest import ROOT, TINY, TINY_STOPPED

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    spec = bench.cell(name)
    assert (ROOT / "benchmark" / "traffic"
            / f"{spec['mix']['kind']}.py").is_file()
    assert spec["config"]["name"] == spec["entry"]["config"]
    assert set(spec["workload"]["judge"]) <= {"xi_ratio", "dyn_gap"}
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    module = bench.load_module(ROOT / "benchmark" / "metrics"
                               / f"{metric}.py")
    assert callable(module.read)


def test_a_new_cell_is_found_from_its_json_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_json = json.loads(json.dumps(BENCH))
    bench_json["workloads"].append(dict(
        name="config4.solve_short", config="config4_network_1e4",
        traffic="cold_cp_short", chips=1, why="a test cell"))
    for m in bench_json["per_layer"]:
        if m["name"] == "solver.iters_per_solve":
            m["workloads"].append("config4.solve_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    (tmp_path / "benchmark" / "traffic" / "cold_cp_short.json").write_text(
        json.dumps(dict(kind="solve", params=dict(
            problems=4, x0_scale=0.1, tol=1e-3, max_iters=100,
            check_every=25))))
    (tmp_path / "benchmark" / "workloads"
     / "config4.solve_short.json").write_text(json.dumps(dict(
         config="config4_network_1e4", traffic="cold_cp_short",
         slice_iterations=50, judge=dict(xi_ratio=1.5))))
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys; sys.path.insert(0, 'benchmark'); import run; "
         "s = run.cell('config4.solve_short'); "
         "print(json.dumps([s['mix']['params']['max_iters'], "
         "[m['name'] for m in s['per_layer']]]))"],
        cwd=tmp_path, capture_output=True, text=True, check=True)
    max_iters, metrics = json.loads(out.stdout)
    assert max_iters == 100
    assert metrics == ["solver.iters_per_solve"]


def test_inputs_repeat_for_a_seed():
    cfg = bp.load_config("config4_network_1e4")
    seed = 2 ** 31 + 12345
    a = bp.initial_states(cfg, seed, 16, 0.5)
    assert np.array_equal(a, bp.initial_states(cfg, seed, 16, 0.5))
    assert not np.array_equal(a, bp.initial_states(cfg, seed + 1, 16, 0.5))
    p1, p2 = bp.plant(cfg), bp.plant(cfg)
    assert all(np.array_equal(getattr(p1, f), getattr(p2, f))
               for f in ("P", "v", "A", "B", "x0"))


def test_the_problems_are_distinct_and_a_seed_picks_their_signs():
    cfg = bp.load_config("config4_network_1e4")
    a = bp.initial_states(cfg, 2 ** 31 + 7, 8, 0.5)
    assert np.array_equal(np.abs(a[0]), np.abs(0.5 * bp.plant(cfg).x0))
    assert len({tuple(np.abs(row)) for row in a}) == 8
    assert np.array_equal(np.abs(a), np.abs(bp.initial_states(cfg, 3, 8,
                                                              0.5)))


def test_a_seed_changes_the_inputs_and_not_the_work():
    """x0 and -x0 take the same iterations and mirrored answers, bit for
    bit: the problem is symmetric under x -> -x."""
    from benchmark import system

    cfg = dict(bp.load_config("config4_network_1e4"), dtype="float32",
               **TINY)
    pl = bp.plant(cfg)
    solver = system.make_solver(system.build_problem(cfg, pl, pl.v), cfg,
                                "cpu", [])
    x0 = 0.5 * pl.x0
    a, b = (solver.solve(s * x0, tol=1e-3, max_iters=5000, check_every=25)
            for s in (1.0, -1.0))
    assert a.num_iters == b.num_iters
    assert np.array_equal(a.primal.x, -b.primal.x)
    assert np.array_equal(a.primal.s, b.primal.s)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json; print(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package():
    tops = _loaded(
        "import sys; sys.path.insert(0, 'benchmark'); import run\n"
        "from pathlib import Path\n"
        "for p in Path('benchmark/traffic').glob('*.py'): "
        "run.load_module(p)\n"
        "for p in Path('benchmark/metrics').glob('*.py'): "
        "run.load_module(p)\n"
        "import benchmark.reference.judge, benchmark.trace, "
        "benchmark.work, benchmark.control")
    assert "raocp_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "raocp_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    tops = _loaded("import benchmark.reference.judge, "
                   "benchmark.reference.cp, benchmark.reference.problem")
    assert not tops & {"raocp_tpu_torch", "raocp_tpu", "jax"}


def _tiny(name):
    spec = bench.cell(name)
    spec["config"] = dict(spec["config"], dtype="float64", **TINY)
    return spec


@pytest.mark.parametrize("shape", [TINY, TINY_STOPPED],
                         ids=["one_count", "stopped"])
def test_the_references_tree_is_the_systems(shape):
    from benchmark import system

    cfg = dict(bp.load_config("config5_network_mpc_1e5"), **shape)
    pl = bp.plant(cfg)
    for v in (pl.v, pl.P[2]):
        ours = bp.markov_tree(pl.P, v, cfg["num_stages"],
                              cfg["stopping_time"])
        theirs = system.build_problem(cfg, pl, v).tree
        assert ours.num_nodes == theirs.num_nodes == cfg["num_nodes"]
        assert np.array_equal(ours.anc[1:], theirs.ancestors[1:])
        assert np.array_equal(ours.mode[1:], theirs.value_at_node(
            np.arange(1, ours.num_nodes)))
        assert np.allclose(ours.prob, theirs.probability_of_node(
            np.arange(ours.num_nodes)))


@pytest.mark.parametrize("shape", [TINY, TINY_STOPPED],
                         ids=["one_count", "stopped"])
def test_the_reference_projects_onto_the_dynamics_and_is_adjoint(shape):
    """L' is L's adjoint, and the dynamics projection is a dense KKT
    solve: on a tree of one child count, and on a stopped one."""
    cfg = dict(bp.load_config("config4_network_1e4"), **shape)
    pl, tree = bp.plant(cfg), bp.config_tree(cfg)
    ref = Reference(cfg, pl, tree, "cpu", torch.float64)
    g = torch.Generator().manual_seed(3)
    z = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_primal().items()}
    e = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_dual().items()}
    for k in ("e3", "e4", "e5", "e6"):
        e[k][0] = 0.0
    z["tau"][0] = 0.0
    Lz, Lte = ref.L(z), ref.Lt(e)
    lhs = sum(float((Lz[k] * e[k]).sum()) for k in e)
    rhs = sum(float((z[k] * Lte[k]).sum()) for k in z)
    assert lhs == pytest.approx(rhs, rel=1e-12)
    # the projection against a dense KKT solve of the same least squares
    N, NL, n, m = ref.N, ref.NL, ref.n, ref.m
    x0 = np.linspace(-1.0, 1.0, n)
    x, u = ref.project_dynamics(z["x"], z["u"], torch.tensor(x0))
    nv = N * n + NL * m
    C = np.zeros((N * n, nv))
    C[:n, :n] = np.eye(n)
    d = np.zeros(N * n)
    d[:n] = x0
    for j in range(1, N):
        i, w = tree.anc[j], tree.mode[j]
        C[j * n:(j + 1) * n, j * n:(j + 1) * n] = np.eye(n)
        C[j * n:(j + 1) * n, i * n:(i + 1) * n] = -pl.A[w]
        C[j * n:(j + 1) * n, N * n + i * m:N * n + (i + 1) * m] = -pl.B[w]
    kkt = np.block([[np.eye(nv), C.T], [C, np.zeros((N * n, N * n))]])
    v = np.concatenate([z["x"].numpy().ravel(), z["u"].numpy().ravel()])
    sol = np.linalg.solve(kkt, np.concatenate([v, d]))[:nv]
    assert np.allclose(sol, np.concatenate([x.numpy().ravel(),
                                            u.numpy().ravel()]), atol=1e-12)


def _run(name, seconds=1.0):
    spec = _tiny(name)
    out = bench.result(spec, bench.run_cell(spec, 2 ** 31 + 5, seconds,
                                            False, device="cpu"),
                       False, dict(platform="cpu"))
    return out


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checks"


def _break(monkeypatch, alter):
    """``alter`` each answer that a solve or a batch solve returns (each
    lane's), past the set-up's warm-up."""
    from raocp_tpu_torch import solver as rt_solver

    solve = rt_solver.Solver.solve
    solve_batch = rt_solver.Solver.solve_batch

    def broken(self, x0, **kw):
        res = solve(self, x0, **kw)
        if kw.get("tol", 1.0) < 1.0:           # not the set-up's warm-up
            alter(res, np.asarray(x0))
        return res

    def broken_batch(self, x0s, **kw):
        results = solve_batch(self, x0s, **kw)
        if kw.get("tol", 1.0) < 1.0:
            for res, x0 in zip(results, np.asarray(x0s)):
                alter(res, x0)
        return results

    monkeypatch.setattr(rt_solver.Solver, "solve", broken)
    monkeypatch.setattr(rt_solver.Solver, "solve_batch", broken_batch)


def _unchanged(res, x0):
    """The solve hands back the state it started from (cold: zero, x0 at
    the root)."""
    res.primal = type(res.primal)(*(np.zeros_like(v) for v in res.primal))
    res.primal.x[0] = x0
    res.dual = type(res.dual)(*(np.zeros_like(v) for v in res.dual))


def _altered(res, x0):
    """The first control, the one a controller applies, altered where it is
    produced."""
    res.primal.u[0] += 0.01


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered],
                         ids=["state_unchanged", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _break(monkeypatch, fault)
    out = _run(name)
    assert not out["correct"]
    assert out["failed"] >= 1


def _stopped_run():
    """The headline cell's harness on a stopped tree (:data:`TINY_STOPPED`,
    whose chain nodes pad their risk rows), on the CPU."""
    spec = bench.cell("config4.solve")
    spec["config"] = dict(spec["config"], dtype="float64", **TINY_STOPPED)
    return bench.result(spec, bench.run_cell(spec, 2 ** 31 + 7, 1.0, False,
                                             device="cpu"),
                        False, dict(platform="cpu"))


def _padded(res, x0):
    """A padded slot of the dual's e1, the last of the last nonleaf node
    (a chain node: 3 own rows of 7), left non-zero."""
    nl = TINY_STOPPED["num_nodes"] - TINY_STOPPED["nodes_per_stage"][-1]
    res.dual.e1[nl - 1, 6] = 1e-3


def test_a_stopped_tree_holds_its_padding_to_zero(monkeypatch):
    out = _stopped_run()
    assert out["correct"], out["checks"]
    assert out["checks"]["pad"] == dict(value=0.0, limit=0.0)
    assert list(out["checks"]) == ["xi_ratio", "dyn_gap", "pad"]
    _break(monkeypatch, _padded)
    out = _stopped_run()
    assert not out["correct"]
    assert out["checks"]["pad"] == dict(value=1e-3, limit=0.0)
    assert out["checks"]["xi_ratio"]["value"] <= 1.5


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda):
    """A short run of the headline cell through the command line, traced:
    a result line with the cell's per-layer metrics, correct."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "config4.solve",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 <= line["metrics"]["device.idle_pct"]["value"] <= 100
