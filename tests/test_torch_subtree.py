"""The port's replicated-spine subtree partition (``raocp_tpu_torch.parallel``,
``Solver(mesh=...)``) on gloo ranks on the CPU, against the JAX package's
partition (``tests/test_subtree.py``) and the port's single-device solve.

The file is its own worker. Run as a script,

    python tests/test_torch_subtree.py --world D --rank r --port p \\
        --out DIR --checks demo,ghosts,...

it is one rank of a D-rank gloo world on ``localhost``: it runs the named
checks (every rank runs every check), writes what each measured to
``DIR/rank{r}.json`` and ``DIR/rank{r}.npz``, and asserts that it never
imported JAX. The tests below spawn one world per world size (D = 1, 2, 3,
all at once), hold the JAX package's partition and the port's single-device
solves in the pytest process meanwhile, and then read the ranks' files: each
check is its own test. JAX is imported only inside the pytest-side
functions.
"""

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIFORM = dict(num_states=8, num_inputs=3, num_modes=3, num_stages=5,
               stopping_time=5)
RAGGED = dict(num_stages=3, stopping_time=3)     # no uniform suffix
# a bound on a world's whole run, and on any one collective
WORLD_TIMEOUT = 600
GROUP_TIMEOUT = 60
# all-reduces of a CP step and of a residual check on these trees: the
# frontier sum of the dynamics sweep, of the two child-slot gathers of the
# kernel projection, and of L'; a check's L' of xi_2 and its one max
STEP_ALL_REDUCES = 4
CHECK_ALL_REDUCES = 2
# the power iteration: one to normalise the start, then L' and two dots
POWER_ALL_REDUCES = (1, 3)


# the production loop; a window of it; relax + adaptive steps, checked at
# every step, in a window
PROD = dict(max_iters=4000, tol=1e-3, check_every=25, unroll=25)
PARTIAL = dict(max_iters=300, tol=1e-9, check_every=25, unroll=25)
# the production loop capped at three chunks of 150
CHUNKED = dict(max_iters=450, tol=1e-3, check_every=25, unroll=25)
WINDOW = dict(max_iters=300, tol=0.0, check_every=25, unroll=25)
RELAX = dict(max_iters=300, tol=0.0, relax=1.5, adaptive=True,
             step_ratio=1.3)
MPC_RUN = dict(num_steps=2, seed=0, max_iters=100, tol=1e-3, check_every=25,
               unroll=25)


def _uniform():
    return port_models.random_network_problem(**UNIFORM)


def _hist_diff(a, b) -> float:
    """max |a - b| over two histories whose unchecked rows are NaN; inf
    when their shapes or NaN rows differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    return float(np.nanmax(np.abs(a - b), initial=0.0))


_SOLVERS = {}


def _partitioned(name, mesh):
    """One partitioned Solver a problem per rank process (built and its
    power iteration run once)."""
    if name not in _SOLVERS:
        problem, x0 = {"uniform": _uniform,
                       "demo": port_models.demo_problem}[name]()
        _SOLVERS[name] = (rt.Solver(problem, mesh=mesh, device="cpu"), x0)
    return _SOLVERS[name]


# -- the worker's checks (every rank runs each; each returns scalars and
#    arrays) -------------------------------------------------------------------

def _raised(fn):
    """'ExceptionType: message' of what ``fn()`` raises, or 'none'."""
    try:
        fn()
    except Exception as e:       # the test asserts type and message
        return f"{type(e).__name__}: {e}"
    return "none"


def _global(res, prefix):
    """A result's iterates and histories as npz entries."""
    out = {f"{prefix}/xi_history": res.xi_history,
           f"{prefix}/delta_history": res.delta_history}
    for tree in (res.primal, res.dual):
        for k, v in tree._asdict().items():
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


# the calls that take the flat node partition on a mesh (the tree, its
# Solver options), each solved for FLAT_WINDOW
FLAT_CASES = {"flat": ("uniform", dict(partition="flat")),
              "pad_auto": ("uniform", dict(pad_multiple=2)),
              "ragged_auto": ("ragged", {})}
FLAT_WINDOW = dict(max_iters=50, tol=0.0)


def _flat_case_problem(tree):
    return _uniform() if tree == "uniform" \
        else port_models.demo_problem(**RAGGED)


def check_misconfig(mesh, args):
    """What a mesh refuses (each 'ExceptionType: message'), and the calls
    that take the flat partition, solved for 50 iterations (the layout
    each took; their iterates for the pytest side)."""
    problem, _ = _uniform()
    ragged, _ = port_models.demo_problem(**RAGGED)
    D = mesh.size()
    from raocp_tpu_torch.parallel import make_mesh
    cases = {
        "no_mesh": lambda: rt.Solver(problem, partition="subtree",
                                     device="cpu"),
        "pad_subtree": lambda: rt.Solver(problem, mesh=mesh,
                                         partition="subtree",
                                         pad_multiple=D, device="cpu"),
        "unknown": lambda: rt.Solver(problem, mesh=mesh, partition="rows",
                                     device="cpu"),
        "ragged_subtree": lambda: rt.Solver(ragged, mesh=mesh,
                                            partition="subtree",
                                            device="cpu"),
        "device": lambda: rt.Solver(problem, mesh=mesh, device="cuda"),
        "mesh_size": lambda: make_mesh("cpu", num_devices=D + 1),
    }
    out = {k: _raised(fn) for k, fn in cases.items()}
    arrays = {}
    for case, (tree, kw) in FLAT_CASES.items():
        spec, x0 = _flat_case_problem(tree)
        solver = rt.Solver(spec, mesh=mesh, device="cpu", **kw)
        res = solver.solve(x0, **FLAT_WINDOW)
        out[case] = "flat" if solver.flat is not None else "not flat"
        arrays.update(_global(res, case))
    return out, arrays


def check_one_rank(mesh, args):
    """A one-rank mesh: 'subtree' refuses it, 'auto' runs the
    single-device path, to the bit, and 'flat' the flat layout of one
    block (the single solve's count and iterates)."""
    problem, x0 = port_models.demo_problem()
    solver = rt.Solver(problem, mesh=mesh, device="cpu")
    res = solver.solve(x0, max_iters=300, tol=1e-3)
    alone = rt.Solver(problem, device="cpu").solve(x0, max_iters=300,
                                                   tol=1e-3)
    same = all(np.array_equal(a, b) for a, b in
               zip(res.primal + res.dual, alone.primal + alone.dual))
    flat = rt.Solver(problem, mesh=mesh, partition="flat", device="cpu")
    fres = flat.solve(x0, max_iters=300, tol=1e-3)
    return dict(
        subtree=_raised(lambda: rt.Solver(problem, mesh=mesh,
                                          partition="subtree",
                                          device="cpu")),
        flat=dict(layout=flat.flat is not None, iters=fres.num_iters,
                  single_iters=alone.num_iters,
                  iterate_diff=max(float(np.abs(a - b).max()) for a, b in
                                   zip(fres.primal + fres.dual,
                                       alone.primal + alone.dual))),
        auto_partitioned=solver.subtree is not None,
        auto_same_bits=bool(same and np.array_equal(res.xi_history,
                                                    alone.xi_history))), {}


def check_demo(mesh, args):
    """The parity gate, partitioned, with the default options."""
    solver, x0 = _partitioned("demo", mesh)
    res = solver.solve(x0, max_iters=2000, tol=1e-3)
    stp = solver.subtree
    return dict(frontier=stp.frontier, iters=res.num_iters,
                converged=res.converged, xi=res.xi.tolist(),
                alpha=res.alpha, objective=res.objective,
                validate=max(solver.validate(res).values()),
                ghost_rows=int((stp.plan.np_ids < 0).sum())), \
        _global(res, "demo")


def check_uniform(mesh, args):
    """The production loop (check_every=25, unroll=25) to 1e-3, and a
    window of relax=1.5 with adaptive steps, on the 364-node tree."""
    solver, x0 = _partitioned("uniform", mesh)
    prod = solver.solve(x0, **PROD)
    ra = solver.solve(x0, **RELAX)
    return dict(frontier=solver.subtree.frontier, prod_iters=prod.num_iters,
                prod_converged=prod.converged, ra_iters=ra.num_iters), \
        {**_global(prod, "prod"), **_global(ra, "ra")}


def check_ghosts(mesh, args):
    """Ghost rows of this rank's block after 50 raw loop steps."""
    out = {}
    for name, (problem, x0) in (("uniform", _uniform()),
                                ("demo", port_models.demo_problem())):
        solver, _ = _partitioned(name, mesh)
        stp = solver.subtree
        z0, eta0 = stp.sp.zero_primal(), stp.sp.zero_dual()
        x0t = torch.as_tensor(x0, dtype=stp.sp.dtype)
        z0.x[0] = x0t
        alpha = 0.999 / solver.operator_norm_sq()
        z, eta, *_ = solver_mod._run_cp(stp.sp, z0, eta0, x0t, alpha,
                                        alpha, 0.0, 50)
        ghost = 0.0
        count = 0
        spaces = dict(x="np", u="nl", y="nl", tau="np", s="np", e1="nl",
                      e2="nl", e3="np", e4="np", e5="np", e6="np", e7="nl",
                      e11="lf", e12="lf", e13="lf", e14="lf")
        for tree in (z, eta):
            for k, v in tree._asdict().items():
                mask = stp.plan.ids(spaces[k])[stp.rank] < 0
                count += int(mask.sum())
                if mask.any():
                    ghost = max(ghost, float(v[torch.as_tensor(mask)]
                                             .abs().max()))
        out[f"{name}_ghost_max"] = ghost
        out[f"{name}_ghost_rows"] = count
    return out, {}


def check_zero_layouts(mesh, args):
    """The shapes and dtypes of the zero block layouts [D * local, ...]."""
    out = {}
    for name in ("uniform", "demo"):
        stp = _partitioned(name, mesh)[0].subtree
        for tree in (stp.zero_primal_global_layout(),
                     stp.zero_dual_global_layout()):
            for k, v in tree._asdict().items():
                assert not v.any()
                out[f"{name}/{k}"] = [list(v.shape), str(v.dtype)]
    return out, {}


def check_warm_start(mesh, args):
    """Warm starts in the global layout: from a single-device partial
    solve into the partition, and a partitioned partial solve for the
    pytest side to resume on one device."""
    problem, x0 = _uniform()
    part = rt.Solver(problem, device="cpu").solve(x0, **PARTIAL)
    solver, _ = _partitioned("uniform", mesh)
    warm = solver.solve(x0, warm_start=(part.primal, part.dual), **PROD)
    ppart = solver.solve(x0, **PARTIAL)
    return dict(warm_iters=warm.num_iters, warm_converged=warm.converged,
                single_partial_converged=part.converged), \
        {**_global(warm, "warm"), **_global(ppart, "ppart")}


def check_chunked(mesh, args):
    """450 iterations of the production loop in chunks of 150 against the
    unchunked loop; a fault on every rank in the second chunk (retried
    from the host snapshot); a fault that persists (a global-layout
    checkpoint, written by rank 0, resumed on one device)."""
    from raocp_tpu_torch.ops.sweep import DeviceFault

    solver, x0 = _partitioned("uniform", mesh)
    plain = solver.solve(x0, **CHUNKED)
    chunked = solver.solve(x0, chunk_iters=150, **CHUNKED)
    real_run = solver_mod._run_cp
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise DeviceFault("injected device fault")
        return real_run(*a, **kw)

    solver_mod._run_cp = flaky
    retried = solver.solve(x0, chunk_iters=150, **CHUNKED)
    calls["n"] = 0

    def dead(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise DeviceFault("injected persistent fault")
        return real_run(*a, **kw)

    solver_mod._run_cp = dead
    ckpt = os.path.join(args.out, "fault.npz")
    fault = _raised(lambda: solver.solve(x0, chunk_iters=150,
                                         checkpoint_on_fault=ckpt, **PROD))
    solver_mod._run_cp = real_run
    z, eta, k = rt.SolverResult.load_checkpoint(ckpt)
    resumed = rt.Solver(_uniform()[0], device="cpu").solve(
        x0, warm_start=(z, eta), **PROD)

    def diff(a, b):
        return max(float(np.abs(np.asarray(u) - np.asarray(v)).max())
                   for u, v in zip(a.primal + a.dual, b.primal + b.dual))

    return dict(
        plain_iters=plain.num_iters, chunked_iters=chunked.num_iters,
        chunked_history_diff=_hist_diff(chunked.xi_history,
                                        plain.xi_history),
        chunked_iterate_diff=diff(chunked, plain),
        retried_iters=retried.num_iters,
        retried_history_diff=_hist_diff(retried.xi_history,
                                        plain.xi_history),
        retried_iterate_diff=diff(retried, plain),
        fault=fault, checkpoint_iters=k,
        checkpoint_rows=int(z.x.shape[0]), resumed_iters=resumed.num_iters,
        resumed_converged=resumed.converged), {}


def check_log_every(mesh, args):
    """log_every and profile_dir on the ranks."""
    solver, x0 = _partitioned("uniform", mesh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = solver.solve(x0, max_iters=100, tol=0.0, log_every=50)
    folder = os.path.join(args.out, "profile")
    solver.solve(x0, max_iters=5, tol=0.0, profile_dir=folder)
    return dict(iters=res.num_iters,
                lines=buf.getvalue().count("[raocp_tpu_torch] iter"),
                traces=sorted(os.listdir(folder))), {}


def check_rejected(mesh, args):
    solver, x0 = _partitioned("uniform", mesh)
    return dict(
        anderson=_raised(lambda: solver.solve(x0, max_iters=10,
                                              accel="anderson")),
        batch=_raised(lambda: solver.solve_batch(np.stack([x0, x0]),
                                                 max_iters=10))), {}


def check_risks(mesh, args):
    """Risks with optional stacked fields under the partition, in a
    window: L2Ball (SOC row masks) and Wasserstein (wide transport-plan y
    rows)."""
    out, arrays = {}, {}
    for name, risk in (("l2ball", rt.L2Ball(0.3)),
                       ("wasserstein", rt.Wasserstein(0.4))):
        problem, x0 = port_models.demo_problem(risk=risk)
        solver = rt.Solver(problem, mesh=mesh, device="cpu")
        res = solver.solve(x0, **WINDOW)
        out[f"{name}_iters"] = res.num_iters
        out[f"{name}_partitioned"] = solver.subtree is not None
        arrays.update(_global(res, name))
    return out, arrays


def check_collectives(mesh, args):
    """All-reduces counted by the port's helper: the power iteration, and
    50 loop steps with a check at every step and with a check every 25."""
    from raocp_tpu_torch.parallel import sharding

    out = {}
    for name, (problem, x0) in (("uniform", _uniform()),
                                ("demo", port_models.demo_problem())):
        solver = rt.Solver(problem, mesh=mesh, device="cpu")
        stp = solver.subtree
        sharding.ALL_REDUCES = 0
        out[f"{name}_lambda"] = solver.operator_norm_sq()
        out[f"{name}_power"] = sharding.ALL_REDUCES
        out[f"{name}_power_iters"] = solver.power_iterations
        x0t = torch.as_tensor(x0, dtype=stp.sp.dtype)
        for every, unroll in ((1, 1), (25, 25)):
            z0, eta0 = stp.sp.zero_primal(), stp.sp.zero_dual()
            z0.x[0] = x0t
            sharding.ALL_REDUCES = sharding.ALL_REDUCE_BYTES = 0
            solver_mod._run_cp(stp.sp, z0, eta0, x0t, 0.1, 0.1, 0.0,
                               50 if every > 1 else 49, check_every=every,
                               unroll=unroll)
            out[f"{name}_every{every}"] = sharding.ALL_REDUCES
            out[f"{name}_every{every}_bytes"] = sharding.ALL_REDUCE_BYTES
    return out, {}


def check_mpc(mesh, args):
    """Two closed-loop demo steps (100 iterations at most) with the mesh
    passed to every cached solver; the second step warm-starts from the
    first's global-layout result."""
    ctl, x0 = port_models.demo_mpc_controller(mesh=mesh, device="cpu")
    run = ctl.run(x0, **MPC_RUN)
    partitioned = all(ctl.solver_for_mode(int(w))[0].subtree is not None
                      for w in run.modes[:-1])
    return dict(partitioned=partitioned, iterations=run.iterations.tolist(),
                modes=run.modes.tolist()), \
        {"mpc/states": run.states, "mpc/inputs": run.inputs}


def check_jax_alpha(mesh, args):
    """The demo at the JAX package's partitioned step size, which the
    pytest process writes to ``DIR/../alpha{D}.json`` while the ranks run
    the other checks."""
    path = os.path.join(os.path.dirname(args.out),
                        f"alpha{mesh.size()}.json")
    deadline = time.monotonic() + WORLD_TIMEOUT / 2
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    with open(path) as fh:
        alpha = json.load(fh)["alpha"]
    solver, x0 = _partitioned("demo", mesh)
    res = solver.solve(x0, max_iters=2000, tol=1e-3, alpha=alpha)
    return dict(iters=res.num_iters, alpha=alpha, converged=res.converged,
                validate=max(solver.validate(res).values())), \
        _global(res, "jax_alpha")


def check_cuda_demo(mesh, args):
    """200 iterations of the demo in float64, partitioned over ranks that
    share the card, for the card's own tests; the loop's captures and
    replays (a partition runs its periods eagerly)."""
    problem, x0 = port_models.demo_problem()
    solver = rt.Solver(problem, dtype=torch.float64, mesh=mesh)
    before = dict(solver_mod.LOOP_COUNTS)
    res = solver.solve(x0, max_iters=200, tol=1e-3)
    ran = {k: solver_mod.LOOP_COUNTS[k] - before[k]
           for k in ("captures", "replays", "periods")}
    return dict(iters=res.num_iters, device=str(solver.subtree.sp.device),
                alpha=res.alpha, device_loop=ran), _global(res, "cuda_demo")


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items()
          if name.startswith("check_")}


def _worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checks", required=True)
    ap.add_argument("--device-type", default="cpu")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from raocp_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                           world_size=args.world, rank=args.rank,
                           timeout=GROUP_TIMEOUT)
    mesh = make_mesh(args.device_type)
    results, arrays = {}, {}
    for name in args.checks.split(","):
        tic = time.perf_counter()
        scalars, arr = CHECKS[name](mesh, args)
        results[name] = dict(scalars, seconds=time.perf_counter() - tic)
        arrays.update(arr)
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "raocp_tpu")
                 or m.startswith(("jax.", "jaxlib", "raocp_tpu.")))
    assert not bad, bad
    results["imports_clean"] = True
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **arrays)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as fh:
        json.dump(results, fh)
    dist.barrier()
    dist.destroy_process_group()


# -- spawning worlds (also used by test_torch_host.py and
#    test_torch_cuda.py) ---------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """D rank processes of ``script`` (this file by default) running
    ``checks``; :meth:`wait` returns every rank's (json, npz). A rank that
    fails kills the rest."""

    def __init__(self, world, checks, out, device_type="cpu", script=None):
        self.out = out
        os.makedirs(out, exist_ok=True)
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("XLA_FLAGS", None)
        self.procs = [subprocess.Popen(
            [sys.executable, script or os.path.abspath(__file__), "--world",
             str(world), "--rank", str(r), "--port", str(port), "--out",
             out, "--checks", ",".join(checks), "--device-type",
             device_type],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait(self, timeout=WORLD_TIMEOUT):
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [p for p in self.procs
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        logs = [p.communicate()[0] for p in self.procs]
        codes = [p.returncode for p in self.procs]
        assert codes == [0] * len(codes), (codes, "\n".join(logs)[-6000:])
        ranks = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.out, f"rank{r}.json")) as fh:
                res = json.load(fh)
            ranks.append((res, dict(np.load(os.path.join(
                self.out, f"rank{r}.npz")))))
        return ranks


def run_world(world, checks, out, device_type="cpu", timeout=WORLD_TIMEOUT):
    return World(world, checks, out, device_type).wait(timeout)


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# -- the tests -------------------------------------------------------------------

# every check in both worlds; the demo with its own step size in the
# 2-rank world (the gate); the demo at the JAX partition's step size last
# (the ranks wait for it)
WORLD_CHECKS = {
    2: ("misconfig", "demo", "uniform", "ghosts", "zero_layouts",
        "warm_start", "chunked", "log_every", "rejected", "risks",
        "collectives", "mpc", "jax_alpha"),
    3: ("misconfig", "uniform", "ghosts", "zero_layouts", "warm_start",
        "chunked", "log_every", "rejected", "risks", "collectives", "mpc",
        "jax_alpha"),
}
# checks whose numbers are a rank's own
PER_RANK = ("ghosts", "log_every")


def _jax():
    import jax  # noqa: F401  (the conftest set x64 and 8 CPU devices)
    import raocp_tpu as rj
    import raocp_tpu.models as jm
    from raocp_tpu.parallel import make_mesh
    return rj, jm, make_mesh


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of 1, 2 and 3 ranks, started together; meanwhile the JAX
    package's partitioned demo for D = 2 and 3, whose step sizes the ranks
    read."""
    base = tmp_path_factory.mktemp("torch_subtree")
    spawned = {1: World(1, ("one_rank",), str(base / "w1"))}
    for D, checks in WORLD_CHECKS.items():
        spawned[D] = World(D, checks, str(base / f"w{D}"))
    rj, jm, make_mesh = _jax()
    jax_res = {}
    for D in WORLD_CHECKS:
        problem, x0 = jm.demo_problem()
        solver = rj.Solver(problem, mesh=make_mesh(num_devices=D))
        assert solver.subtree is not None
        jax_res[D] = solver.solve(x0, max_iters=2000, tol=1e-3)
        with open(base / f"alpha{D}.json", "w") as fh:
            json.dump({"alpha": jax_res[D].alpha}, fh)
    # the single-device references, while the ranks run
    for key in ("demo", "prod", "ra", "l2ball", "wasserstein", "part",
                "warm", "mpc"):
        _single(key)
    for D in WORLD_CHECKS:
        _single("demo", jax_res[D].alpha)
    out = {D: w.wait() for D, w in spawned.items()}
    out["jax"] = jax_res
    return out


_SINGLE = {}


def _single(key, alpha=None):
    """The port's single-device runs that the partitioned ones are held
    against (float64, the CPU), each made once."""
    if (key, alpha) in _SINGLE:
        return _SINGLE[key, alpha]
    if key == "mpc":
        ctl, x0 = port_models.demo_mpc_controller(device="cpu")
        out = ctl.run(x0, **MPC_RUN)
    elif key == "warm":
        part = _single("part")
        problem, x0 = _uniform()
        out = rt.Solver(problem, device="cpu").solve(
            x0, warm_start=(part.primal, part.dual), **PROD)
    else:
        make, opts = {
            "demo": (port_models.demo_problem, dict(max_iters=2000,
                                                    tol=1e-3)),
            "prod": (_uniform, PROD),
            "part": (_uniform, PARTIAL),
            "ra": (_uniform, RELAX),
            "l2ball": (lambda: port_models.demo_problem(
                risk=rt.L2Ball(0.3)), WINDOW),
            "wasserstein": (lambda: port_models.demo_problem(
                risk=rt.Wasserstein(0.4)), WINDOW),
        }[key]
        problem, x0 = make()
        out = rt.Solver(problem, device="cpu").solve(x0, alpha=alpha,
                                                     **opts)
    _SINGLE[key, alpha] = out
    return out


def _assert_iterates(arrays, prefix, res, atol):
    for tree in (res.primal, res.dual):
        for k, v in tree._asdict().items():
            np.testing.assert_allclose(arrays[f"{prefix}/{k}"], v, rtol=0,
                                       atol=atol, err_msg=f"{prefix}/{k}")


def _rank0(worlds, D, check):
    return worlds[D][0][0][check]


# in-process: the frontier and the host plan against the JAX package ---------

def test_frontier_choice_matches_jax():
    """Uniform tree (stage 3 at D = 8), ragged spine (the demo's leaf
    stage at D = 2, 3, 4, 8), fully ragged rejected; from the tree, the
    spec and the built problem alike, equal to the JAX package's."""
    from raocp_tpu.parallel import subtree as jsub
    from raocp_tpu_torch.core.stacked import build_stacked
    from raocp_tpu_torch.parallel import choose_frontier, subtree_eligible

    _, jm, _ = _jax()
    uniform, _ = _uniform()
    demo, _ = port_models.demo_problem()
    ragged, _ = port_models.demo_problem(**RAGGED)
    assert choose_frontier(uniform.tree, 8) == 3
    for D in (2, 3, 4, 8):
        assert choose_frontier(demo, D) == demo.tree.num_stages - 1
    assert not subtree_eligible(ragged.tree)
    assert choose_frontier(ragged.tree, 2) is None
    for port, ref in ((uniform, jm.random_network_problem(**UNIFORM)[0]),
                      (demo, jm.demo_problem()[0]),
                      (ragged, jm.demo_problem(**RAGGED)[0])):
        built = build_stacked(port, device="cpu")
        assert subtree_eligible(port) == jsub.subtree_eligible(ref.tree) \
            == subtree_eligible(built)
        for D in range(1, 9):
            assert choose_frontier(port.tree, D) \
                == jsub.choose_frontier(ref.tree, D) \
                == choose_frontier(built, D)


@pytest.mark.parametrize("family", ["demo", "uniform"])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_host_plan_matches_jax(family, D):
    """The port's host plan equals the JAX partition's host arrays: the
    frontier, the id maps, and each device's index-plan block."""
    from raocp_tpu.parallel.subtree import build_subtree_problem
    from raocp_tpu_torch.parallel import subtree_plan

    _, jm, make_mesh = _jax()
    if family == "demo":
        ref, _ = jm.demo_problem()
        port, _ = port_models.demo_problem()
    else:
        ref, _ = jm.random_network_problem(**UNIFORM)
        port, _ = _uniform()
    stp = build_subtree_problem(ref, make_mesh(num_devices=D))
    plan = subtree_plan(port, D)
    assert plan.frontier == stp.frontier
    assert (plan.l_np, plan.l_nl, plan.l_lf) == (stp.l_np, stp.l_nl,
                                                 stp.l_lf)
    for name in ("np_ids", "to_np", "to_nl", "to_lf"):
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(stp, name), err_msg=name)
    np.testing.assert_array_equal(plan.lf_ids, stp._lf_ids)
    for name, rows in (("anc", stp.l_np), ("child_rank", stp.l_np),
                       ("child_idx", stp.l_nl), ("child_mask", stp.l_nl)):
        want = np.asarray(getattr(stp.sp, name))
        want = want.reshape((D, rows) + want.shape[1:])
        np.testing.assert_array_equal(getattr(plan, name), want,
                                      err_msg=name)


# the worlds ----------------------------------------------------------------------

def test_one_rank_mesh(worlds):
    """A one-rank mesh: 'auto' runs the single-device path (the same
    bits), 'subtree' refuses it, 'flat' runs the flat layout of one block
    with the single solve's count and iterates (1e-12)."""
    got = worlds[1][0][0]["one_rank"]
    assert got["subtree"].startswith("ValueError") \
        and "more than one device" in got["subtree"]
    flat = got["flat"]
    assert flat["layout"] and flat["iters"] == flat["single_iters"]
    assert flat["iterate_diff"] <= 1e-12
    assert not got["auto_partitioned"] and got["auto_same_bits"]


@pytest.mark.parametrize("D", [2, 3])
def test_ranks_import_no_jax_and_agree(worlds, D):
    """No rank imported JAX; every rank reports the same numbers and
    returns the same global arrays, bit for bit."""
    first, first_arr = worlds[D][0]
    for res, arr in worlds[D]:
        assert res["imports_clean"]
        for check in WORLD_CHECKS[D]:
            if check in PER_RANK:
                continue
            a = {k: v for k, v in first[check].items() if k != "seconds"}
            b = {k: v for k, v in res[check].items() if k != "seconds"}
            assert a == b, check
        assert arr.keys() == first_arr.keys()
        for k in first_arr:
            np.testing.assert_array_equal(arr[k], first_arr[k], err_msg=k)


def _assert_flat_cases_match_single(got, arrays):
    """The calls of FLAT_CASES took the flat layout and match the
    single-device solve of the same window (1e-12)."""
    for case, (tree, _) in FLAT_CASES.items():
        assert got[case] == "flat", case
        spec, x0 = _flat_case_problem(tree)
        _assert_iterates(arrays, case, rt.Solver(spec, device="cpu").solve(
            x0, **FLAT_WINDOW), 1e-12)


@pytest.mark.parametrize("D", [2, 3])
def test_misconfig_rejected(worlds, D):
    """What a mesh still refuses; ``partition="flat"``, ``pad_multiple``
    under "auto" and a tree with no frontier under "auto" take the flat
    partition and solve as the single device does."""
    got = _rank0(worlds, D, "misconfig")
    assert got["no_mesh"].startswith("ValueError") and "needs a mesh" \
        in got["no_mesh"]
    assert got["pad_subtree"].startswith("ValueError") and "pad_multiple" \
        in got["pad_subtree"] and "partition='flat'" in got["pad_subtree"]
    _assert_flat_cases_match_single(got, worlds[D][0][1])
    assert got["unknown"].startswith("ValueError")
    assert got["ragged_subtree"].startswith("ValueError") \
        and "uniform branching" in got["ragged_subtree"] \
        and "partition='flat'" in got["ragged_subtree"]
    assert got["device"].startswith("ValueError") and "conflicts" \
        in got["device"]
    assert got["mesh_size"].startswith("ValueError")


def test_demo_937_partitioned(worlds):
    """THE gate, partitioned over 2 ranks with the default options (the
    step size from the partitioned power iteration): 937 iterations, the
    reference's residuals, the single-device iterates and histories to
    1e-12, validate below 1e-10. The frontier is the leaf stage (the leaf
    space's maps)."""
    got = _rank0(worlds, 2, "demo")
    arrays = worlds[2][0][1]
    assert got["converged"] and got["iters"] == 937
    assert got["frontier"] == 4
    np.testing.assert_allclose(got["xi"], [9.9508e-4, 9.4106e-4, 9.5599e-4],
                               rtol=1e-3)
    single = _single("demo")
    assert got["alpha"] == pytest.approx(single.alpha, rel=1e-10)
    _assert_iterates(arrays, "demo", single, 1e-12)
    # the two power iterations' step sizes differ by about 2e-13
    # (relative), and xi divides iterate differences by the step: the
    # history is held to 1e-12 of its largest entry
    hist = single.xi_history
    assert np.abs(arrays["demo/xi_history"] - hist).max() \
        <= 1e-12 * np.abs(hist).max()
    assert got["validate"] < 1e-10


@pytest.mark.parametrize("D", [2, 3])
def test_demo_matches_jax_partitioned_history(worlds, D):
    """At the JAX partition's step size the port's partitioned demo takes
    JAX's 937 iterations with its xi / delta histories to 1e-10, and the
    port's single-device iterates at that step size to 1e-12."""
    got = _rank0(worlds, D, "jax_alpha")
    arrays = worlds[D][0][1]
    want = worlds["jax"][D]
    assert got["alpha"] == want.alpha
    assert got["converged"] and got["iters"] == want.num_iters == 937
    np.testing.assert_allclose(arrays["jax_alpha/xi_history"],
                               want.xi_history, rtol=0, atol=1e-10)
    np.testing.assert_allclose(arrays["jax_alpha/delta_history"],
                               want.delta_history, rtol=0, atol=1e-10)
    single = _single("demo", want.alpha)
    _assert_iterates(arrays, "jax_alpha", single, 1e-12)
    np.testing.assert_allclose(arrays["jax_alpha/xi_history"],
                               single.xi_history, rtol=0, atol=1e-12)
    assert got["validate"] < 1e-10


@pytest.mark.parametrize("D", [2, 3])
def test_uniform_production_config(worlds, D):
    """check_every=25 / unroll=25 on the 364-node tree: the single
    solve's count and iterates."""
    got = _rank0(worlds, D, "uniform")
    single = _single("prod")
    assert got["prod_converged"] and got["prod_iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], "prod", single, 1e-12)
    assert _hist_diff(worlds[D][0][1]["prod/xi_history"],
                      single.xi_history) <= 1e-12


@pytest.mark.parametrize("D", [2, 3])
def test_relax_adaptive(worlds, D):
    """Over-relaxation, adaptive steps and a step ratio, checked at every
    step (300 iterations): the rebalance reads the all-reduced residuals,
    so the ranks rebalance alike, and as the single solve does."""
    got = _rank0(worlds, D, "uniform")
    single = _single("ra")
    assert got["ra_iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], "ra", single, 1e-12)
    np.testing.assert_allclose(worlds[D][0][1]["ra/xi_history"],
                               single.xi_history, rtol=0, atol=1e-12)


@pytest.mark.parametrize("D", [2, 3])
def test_ghost_rows_stay_zero(worlds, D):
    """Ghost rows (the padding of uneven stages: the uniform tree at D =
    2, the demo's 16 leaves at D = 3) are exactly zero."""
    rows = 0
    for res, _ in worlds[D]:
        g = res["ghosts"]
        assert g["uniform_ghost_max"] == 0.0 and g["demo_ghost_max"] == 0.0
        rows += g["uniform_ghost_rows"] + g["demo_ghost_rows"]
    assert rows > 0


@pytest.mark.parametrize("D", [2, 3])
def test_zero_layouts_match_jax(worlds, D):
    """The zero block layouts have the JAX partition's shapes and dtypes."""
    from raocp_tpu.parallel.subtree import build_subtree_problem

    _, jm, make_mesh = _jax()
    got = _rank0(worlds, D, "zero_layouts")
    for name, make in (("uniform", lambda: jm.random_network_problem(
            **UNIFORM)), ("demo", jm.demo_problem)):
        stp = build_subtree_problem(make()[0], make_mesh(num_devices=D))
        for tree in (stp.zero_primal_global_layout(),
                     stp.zero_dual_global_layout()):
            for k, v in tree._asdict().items():
                assert got[f"{name}/{k}"] == [list(v.shape), str(v.dtype)], \
                    (name, k)


@pytest.mark.parametrize("D", [2, 3])
def test_checkpoint_warm_start_across_layouts(worlds, D):
    """A single-device partial solve warm-starts the partition (the single
    warm solve's count and iterates), and a partitioned partial solve, in
    the global layout, warm-starts a single-device solve."""
    got = _rank0(worlds, D, "warm_start")
    arrays = worlds[D][0][1]
    problem, x0 = _uniform()
    part, warm1 = _single("part"), _single("warm")
    assert not part.converged and not got["single_partial_converged"]
    assert got["warm_converged"]
    assert got["warm_iters"] == warm1.num_iters < _single("prod").num_iters
    _assert_iterates(arrays, "warm", warm1, 1e-12)
    # the other way round: a partitioned partial solve resumed on one device
    _assert_iterates(arrays, "ppart", part, 1e-12)
    zp = rt.core.Primal(*(arrays[f"ppart/{k}"]
                          for k in rt.core.Primal._fields))
    ep = rt.core.Dual(*(arrays[f"ppart/{k}"] for k in rt.core.Dual._fields))
    resumed = rt.Solver(problem, device="cpu").solve(
        x0, warm_start=(zp, ep), **PROD)
    assert resumed.num_iters == warm1.num_iters


@pytest.mark.parametrize("D", [2, 3])
def test_chunked_matches_plain(worlds, D):
    """450 iterations of the production loop in chunks of 150: the
    unchunked loop's count, history and iterates."""
    got = _rank0(worlds, D, "chunked")
    assert got["chunked_iters"] == got["plain_iters"] == 450
    assert got["chunked_history_diff"] <= 1e-12
    assert got["chunked_iterate_diff"] <= 1e-12


@pytest.mark.parametrize("D", [2, 3])
def test_fault_on_every_rank_recovered(worlds, D):
    """A fault on every rank in the second chunk is retried from the host
    snapshot (the unchunked solve's history and iterates); one that
    persists writes a global-layout checkpoint after the first chunk (150
    iterations) that a single-device solve resumes."""
    got = _rank0(worlds, D, "chunked")
    assert got["retried_iters"] == got["plain_iters"]
    assert got["retried_history_diff"] <= 1e-12
    assert got["retried_iterate_diff"] <= 1e-12
    assert got["fault"].startswith("RuntimeError") and "saved to" \
        in got["fault"]
    assert got["checkpoint_iters"] == 150
    assert got["checkpoint_rows"] == _uniform()[0].tree.num_nodes
    assert got["resumed_converged"]
    assert got["resumed_iters"] + 150 <= _single("prod").num_iters + 25


@pytest.mark.parametrize("D", [2, 3])
def test_log_every_prints_once(worlds, D):
    """Rank 0 prints each log line (k = 0, 50, 100); the others print
    none."""
    lines = [res["log_every"]["lines"] for res, _ in worlds[D]]
    assert lines == [3] + [0] * (D - 1)
    assert _rank0(worlds, D, "log_every")["iters"] == 101


@pytest.mark.parametrize("D", [2, 3])
def test_profile_dir_one_trace_per_rank(worlds, D):
    """``profile_dir`` under the partition: each rank writes its own
    trace (``trace.rank{r}.json``) into the shared folder."""
    assert _rank0(worlds, D, "log_every")["traces"] == [
        f"trace.rank{r}.json" for r in range(D)]


@pytest.mark.parametrize("D", [2, 3])
def test_accel_and_batch_rejected(worlds, D):
    got = _rank0(worlds, D, "rejected")
    assert got["anderson"].startswith("ValueError")
    assert got["batch"].startswith("ValueError")


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("risk", ["l2ball", "wasserstein"])
def test_soc_risk_and_wasserstein(worlds, D, risk):
    """300 production-loop iterations: the single solve's iterates."""
    got = _rank0(worlds, D, "risks")
    single = _single(risk)
    assert got[f"{risk}_partitioned"]
    assert got[f"{risk}_iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], risk, single, 1e-12)


@pytest.mark.parametrize("D", [2, 3])
def test_all_reduces_pinned(worlds, D):
    """The port's counterpart of the JAX package's collective budget,
    counted by the port's all-reduce helper: per CP step the frontier sums
    of the dynamics sweep, of the kernel projection's two child-slot
    gathers and of L' (4); per check the L' of xi_2 and the one max of the
    six norms (2); one more for the loop's first L'. The power iteration
    (1 + 3 a step) gives the single-device lambda."""
    got = _rank0(worlds, D, "collectives")
    first, per = POWER_ALL_REDUCES
    for name, make in (("uniform", _uniform),
                       ("demo", port_models.demo_problem)):
        assert got[f"{name}_every1"] == 1 + 50 * (STEP_ALL_REDUCES
                                                  + CHECK_ALL_REDUCES)
        assert got[f"{name}_every25"] == 1 + 50 * STEP_ALL_REDUCES \
            + 2 * CHECK_ALL_REDUCES
        assert got[f"{name}_power"] == first + per * got[
            f"{name}_power_iters"]
        lam = rt.Solver(make()[0], device="cpu").operator_norm_sq()
        assert got[f"{name}_lambda"] == pytest.approx(lam, rel=1e-10)


@pytest.mark.parametrize("D", [2, 3])
def test_mpc_with_mesh(worlds, D):
    """``demo_mpc_controller(mesh=...)``: every cached solver partitioned,
    and the single-device controller's modes, counts, states and inputs."""
    got = _rank0(worlds, D, "mpc")
    arrays = worlds[D][0][1]
    want = _single("mpc")
    assert got["partitioned"]
    assert got["modes"] == want.modes.tolist()
    assert got["iterations"] == want.iterations.tolist()
    np.testing.assert_allclose(arrays["mpc/states"], want.states, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(arrays["mpc/inputs"], want.inputs, rtol=0,
                               atol=1e-12)
