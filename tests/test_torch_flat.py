"""The port's flat node partition (``partition="flat"``,
``raocp_tpu_torch.parallel.shard_problem``) on gloo ranks on the CPU,
against the JAX package's flat partition (``tests/test_sharding.py``, on
the 8 virtual CPU devices of ``tests/conftest.py``) and the port's
single-device solve. Float64 throughout. JAX pads every node space to a
multiple of 8 and the port to one of D, so only real rows are compared.

The file is its own worker (as ``tests/test_torch_subtree.py``). Run as a
script,

    python tests/test_torch_flat.py --world D --rank r --port p \\
        --out DIR --checks ops,demo,...

it is one rank of a D-rank gloo world on ``localhost``: it runs the named
checks, writes what each measured to ``DIR/rank{r}.json`` and
``DIR/rank{r}.npz`` and asserts that it never imported JAX. The fixture
below starts the D = 2 and D = 3 worlds at once and meanwhile runs the JAX
package's flat partition and the port's single-device references in the
pytest process; each check is then its own test.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
import raocp_tpu_torch.solver as solver_mod  # noqa: E402
from test_torch_subtree import World, _hist_diff  # noqa: E402

UNIFORM = dict(num_states=8, num_inputs=3, num_modes=3, num_stages=5,
               stopping_time=5)
RAGGED = dict(num_stages=3, stopping_time=3)     # no subtree frontier
GROUP_TIMEOUT = 60
WORLD_TIMEOUT = 600
DEMO = dict(max_iters=2000, tol=1e-3)
PROD = dict(max_iters=2000, tol=1e-3, check_every=25, unroll=25)
RELAX = dict(max_iters=2000, tol=1e-3, relax=1.5, adaptive=True)
WINDOW = dict(max_iters=300, tol=0.0, check_every=25, unroll=25)
PARTIAL = dict(max_iters=150, tol=1e-9, check_every=25, unroll=25)
RESUMED = dict(max_iters=200, tol=0.0, check_every=25, unroll=25)
CHUNKED = dict(max_iters=300, tol=1e-3, check_every=25, unroll=25)
CHUNK = 100
MPC_RUN = dict(num_steps=2, seed=0, max_iters=300, tol=1e-3)
ANDERSON_WINDOW = 60
SUPERMANN_WINDOW = 40
BATCH_SCALES = (1.0, 0.5, -0.3)
SMALL_WINDOW = dict(max_iters=50, tol=1e-3)
STEP_ALPHA = 0.2
# the operator and step fixtures: problem families, and variants of a
# built problem that take L / L''s other branches
OPS_CASES = ("demo", "l2poly", "wasserstein", "ragged", "chain", "socnet",
             "uniform", "demo_unstacked", "demo_unfused", "demo_dense")
JAX_OPS_CASES = ("demo", "l2poly", "wasserstein")
LANES = 2


def _problem(name, models=port_models, rt_mod=rt):
    """A fixture problem of either package (``models`` / ``rt_mod``)."""
    if name in ("demo", "demo_unstacked", "demo_unfused", "demo_dense"):
        return models.demo_problem()
    if name == "ragged":
        return models.demo_problem(**RAGGED)
    if name == "uniform":
        return models.random_network_problem(**UNIFORM)
    if name == "chain":              # mode-constant Riccati chain stages
        return models.random_network_problem(
            num_states=4, num_inputs=2, num_modes=3, num_stages=5,
            stopping_time=3)
    if name == "socnet":
        return models.soc_network_problem(num_states=4, num_inputs=2,
                                          num_modes=2, num_stages=4,
                                          stopping_time=2)
    if name == "l2poly":
        problem, x0 = models.demo_problem(risk=rt_mod.L2Ball(0.3))
        G = np.vstack([np.eye(5), [[1.0, -1.0, 0.0, 0.0, 1.0]]])
        problem.with_all_nonleaf_constraints(rt_mod.Polyhedral(
            rt_mod.Nonleaf(), G, -np.full(6, 7.0), np.full(6, 7.0)))
        return problem, x0
    if name == "wasserstein":
        return models.demo_problem(risk=rt_mod.Wasserstein(0.4))
    raise KeyError(name)


def _variant(name, sp):
    """The ``demo_*`` variants: no stage-stacked L blocks; no fused
    blockdiag(sqrtQ, sqrtR); and dense per-node sqrtQ / sqrtR stacks."""
    from raocp_tpu_torch.core.modal import ModalMatrix

    none = tuple(None for _ in sp.qr_fwd)
    if name == "demo_unstacked":
        return dataclasses.replace(sp, qr_fwd=none, qr_bwd=none)
    if name == "demo_unfused":
        return dataclasses.replace(sp, QRm=None, qr_fwd=none, qr_bwd=none)
    if name == "demo_dense":
        return dataclasses.replace(
            sp, QRm=None, qr_fwd=none, qr_bwd=none,
            sqrtQ=ModalMatrix(sp.sqrtQ.dense(), None, None),
            sqrtR=ModalMatrix(sp.sqrtR.dense(), None, None))
    return sp


def _inputs(sp, seed=0, lanes=None):
    """Random (z, eta) at the global real shapes of a port problem ``sp``
    (NumPy), zero where the padding invariants want zeros (JAX
    ``tests/util.py``): the same arrays on every rank and in pytest."""
    rng = np.random.default_rng(seed)
    N, NL, LF = sp.num_nodes, sp.num_nonleaf, sp.num_leaf
    lead = () if lanes is None else (lanes,)
    y_mask = sp.y_mask[:NL].numpy()
    nz = sp.nz_mask[:N].numpy()
    nl_act = sp.nl_active[:NL].numpy()
    l_act = sp.l_active[:LF].numpy()

    def r(*shape):
        return rng.standard_normal(lead + shape)

    z = rt.core.Primal(x=r(N, sp.n), u=r(NL, sp.m), y=r(NL, sp.Y) * y_mask,
                       tau=r(N) * nz, s=r(N))
    eta = rt.core.Dual(
        e1=r(NL, sp.Y) * y_mask, e2=r(NL), e3=r(N, sp.n) * nz[:, None],
        e4=r(N, sp.m) * nz[:, None], e5=r(N) * nz, e6=r(N) * nz,
        e7=r(NL, sp.nl_rows) * nl_act[:, None], e11=r(LF, sp.n), e12=r(LF),
        e13=r(LF), e14=r(LF, sp.l_rows) * l_act[:, None])
    return z, eta


def _embed(tree, zero):
    """Real-row arrays into the zero padded layout ``zero``."""
    out = []
    for v, z0 in zip(tree, zero):
        w = np.zeros(tuple(z0.shape))
        w[:v.shape[0]] = v
        out.append(w)
    return type(tree)(*out)


def _save(prefix, tree):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in tree._asdict().items()}


def _global(res, prefix):
    out = {f"{prefix}/xi_history": res.xi_history,
           f"{prefix}/delta_history": res.delta_history}
    for tree in (res.primal, res.dual):
        out.update(_save(prefix, tree))
    return out


def _raised(fn):
    try:
        fn()
    except Exception as e:       # the test asserts type and message
        return f"{type(e).__name__}: {e}"
    return "none"


_SOLVERS = {}


def _flat_solver(name, mesh):
    """One ``partition="flat"`` Solver a fixture per rank process (built
    and its power iteration run once)."""
    if name not in _SOLVERS:
        problem, x0 = _problem(name)
        _SOLVERS[name] = (rt.Solver(problem, mesh=mesh, partition="flat",
                                    device="cpu"), x0)
    return _SOLVERS[name]


# -- the worker's checks -------------------------------------------------------

def check_ops(mesh, args):
    """L, L' and one CP step (with its residuals) on every fixture, from
    the same random inputs, on the rank's blocks; a batch of lanes on the
    demo and the chain tree."""
    from raocp_tpu_torch.core.stacked import build_stacked
    from raocp_tpu_torch.ops.operator import ell, ell_t
    from raocp_tpu_torch.parallel import shard_problem, shard_variables
    from raocp_tpu_torch.parallel.flat import FlatProblem
    from raocp_tpu_torch.solver import _cp_residuals, _cp_step

    D = mesh.size()
    arrays = {}
    for name in OPS_CASES:
        problem, x0 = _problem(name)
        g = _variant(name, build_stacked(problem, pad_multiple=D,
                                         device="cpu"))
        fp = FlatProblem(shard_problem(g, mesh))
        sp = fp.sp
        for lanes in ((None, LANES) if name in ("demo", "chain")
                      else (None,)):
            z, eta = _inputs(g, lanes=lanes)
            if lanes:
                z, eta = _lane_blocks(fp, z), _lane_blocks(fp, eta)
            else:
                z = shard_variables(_embed(z, g.zero_primal()), mesh)
                eta = shard_variables(_embed(eta, g.zero_dual()), mesh)
            x0t = torch.as_tensor(
                np.stack([x0] * lanes) if lanes else x0, dtype=sp.dtype)
            Lz, Lt = ell(sp, z), ell_t(sp, eta)
            zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, STEP_ALPHA,
                                        STEP_ALPHA, x0t)
            err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn,
                                      STEP_ALPHA, STEP_ALPHA)
            tag = name + ("" if lanes is None else "_lanes")
            for key, tree in (("L", Lz), ("Lt", Lt), ("zn", zn), ("en", en),
                              ("Lzn", Lzn), ("Ltn", Ltn)):
                to = fp.primal_to_global if key in ("Lt", "zn", "Ltn") \
                    else fp.dual_to_global
                arrays.update(_save(f"{tag}/{key}", to(tree)))
            arrays[f"{tag}/err"] = err.numpy()
            arrays[f"{tag}/derr"] = derr.numpy()
    return {}, arrays


def _lane_blocks(fp, tree):
    """This rank's blocks (tensors) of real-row arrays with a leading lane
    axis."""
    to_local = fp.primal_to_local if len(tree) == 5 else fp.dual_to_local
    lanes = [to_local(type(tree)(*(v[b] for v in tree)))
             for b in range(tree[0].shape[0])]
    return type(tree)(*(torch.as_tensor(np.stack(leaf)) for leaf in
                        zip(*lanes)))


def check_layout(mesh, args):
    """What a rank holds: every node-leading field of its problem is a row
    block (``np_pad / D``, ``nl_pad / D`` or ``lf_pad / D`` rows), its halo
    tables cover its planned windows, and every exchange of a CP step
    brings exactly its planned windows."""
    import raocp_tpu_torch.parallel.flat as flat_mod
    from raocp_tpu_torch.core.stacked import STATIC_FIELDS

    def rows_of(v):
        """Dim 0 of a node-leading tensor or mode-grouped stack (None for
        what is not node-leading)."""
        if hasattr(v, "modes"):
            v = v.dense_m if v.dense_m is not None else v.idx
        return None if not isinstance(v, torch.Tensor) or v.dim() == 0 \
            else int(v.shape[0])

    out = {}
    for name in ("demo", "uniform"):
        solver, x0 = _flat_solver(name, mesh)
        g, fp = solver.stacked, solver.flat
        sp, plan = fp.sp, fp.plan
        D = mesh.size()
        bad = []
        for f in dataclasses.fields(sp):
            if f.name in STATIC_FIELDS or isinstance(getattr(sp, f.name),
                                                     tuple):
                continue                     # metadata, replicated stages
            local, full = rows_of(getattr(sp, f.name)), \
                rows_of(getattr(g, f.name))
            if f.name == "lf_half_mask":
                full = g.lf_pad
            if f.name in ("nl_G", "l_G"):    # replicated
                continue
            if local is not None and local * D != full:
                bad.append(f.name)
        tab_rows = {k: rows_of(t) for k, t in plan.tables.items()
                    if t is not None}
        seen = []
        real = flat_mod.exchange

        def recording(pulls, rank, group):
            wins = real(pulls, rank, group)
            seen.append([(int(w.shape[-2]), p.need[rank][1] - p.need[rank][0])
                         for (p, _), w in zip(pulls, wins)])
            return wins

        flat_mod.exchange = recording
        try:
            z0, eta0 = sp.zero_primal(), sp.zero_dual()
            if fp.rank == 0:
                z0.x[0] = torch.as_tensor(x0)
            solver_mod._run_cp(sp, z0, eta0, torch.as_tensor(x0), 0.1, 0.1,
                               0.0, 1)
        finally:
            flat_mod.exchange = real
        cw = plan.window("np>child")
        largest = max(w for ex in seen for w, _ in ex)
        out[name] = dict(
            blocks=[sp.np_pad, sp.nl_pad, sp.lf_pad],
            global_rows=[g.np_pad, g.nl_pad, g.lf_pad],
            not_a_block=bad, child_window=list(cw),
            table_rows=tab_rows, nl_rows=plan.real["nl"][1]
            - plan.real["nl"][0], q_block=sp.nl_pad,
            windows_as_planned=all(w == n for ex in seen for w, n in ex),
            exchanges_in_a_step=len(seen), largest_window=largest,
            num_nodes=g.num_nodes, D=D)
    return out, {}


def check_demo(mesh, args):
    """The parity gate on the flat layout, with the default options."""
    solver, x0 = _flat_solver("demo", mesh)
    res = solver.solve(x0, **DEMO)
    return dict(iters=res.num_iters, converged=res.converged,
                xi=res.xi.tolist(), alpha=res.alpha,
                flat=solver.flat is not None and solver.subtree is None,
                validate=max(solver.validate(res).values()),
                rows=int(res.primal.x.shape[0])), _global(res, "demo")


def check_loops(mesh, args):
    """The production loop (check_every=25, unroll=25) and relax=1.5 with
    adaptive steps, to 1e-3."""
    solver, x0 = _flat_solver("demo", mesh)
    prod = solver.solve(x0, **PROD)
    relax = solver.solve(x0, **RELAX)
    return dict(prod_iters=prod.num_iters, relax_iters=relax.num_iters,
                prod_converged=prod.converged,
                relax_converged=relax.converged), \
        {**_global(prod, "prod"), **_global(relax, "relax")}


def check_ragged(mesh, args):
    """A tree with no subtree frontier under "auto" takes the flat
    layout."""
    problem, x0 = _problem("ragged")
    solver = rt.Solver(problem, mesh=mesh, device="cpu")
    res = solver.solve(x0, **DEMO)
    return dict(flat=solver.flat is not None, iters=res.num_iters,
                converged=res.converged), _global(res, "ragged")


def check_pad(mesh, args):
    """``pad_multiple=4`` on a mesh: "auto" takes the flat layout, every
    space padded to a multiple of lcm(4, D)."""
    problem, x0 = _problem("demo")
    solver = rt.Solver(problem, mesh=mesh, pad_multiple=4, device="cpu")
    res = solver.solve(x0, **WINDOW)
    sp = solver.stacked
    return dict(flat=solver.flat is not None,
                pads=[sp.np_pad, sp.nl_pad, sp.lf_pad],
                iters=res.num_iters), _global(res, "pad")


def check_ghosts(mesh, args):
    """Ghost rows of this rank's blocks after 50 raw loop steps."""
    from raocp_tpu_torch.parallel.flat import _DUAL_SPACES, _PRIMAL_SPACES
    out = {}
    for name in ("demo", "uniform"):
        solver, x0 = _flat_solver(name, mesh)
        fp = solver.flat
        sp = fp.sp
        z0, eta0 = sp.zero_primal(), sp.zero_dual()
        x0t = torch.as_tensor(x0, dtype=sp.dtype)
        if fp.rank == 0:
            z0.x[0] = x0t
        alpha = 0.999 / solver.operator_norm_sq()
        z, eta, *_ = solver_mod._run_cp(sp, z0, eta0, x0t, alpha, alpha,
                                        0.0, 50)
        ghost, count = 0.0, 0
        spaces = {**_PRIMAL_SPACES, **_DUAL_SPACES}
        for tree in (z, eta):
            for k, v in tree._asdict().items():
                real = fp.plan.real[spaces[k]]
                start = fp.plan.start[spaces[k]]
                tail = v[real[1] - start:]
                count += int(tail.shape[0])
                if tail.numel():
                    ghost = max(ghost, float(tail.abs().max()))
        out[f"{name}_ghost_max"] = ghost
        out[f"{name}_ghost_rows"] = count
    return out, {}


def check_collectives(mesh, args):
    """Exchanges and all-reduces counted by the port's helpers: the power
    iteration, and 50 loop steps with a check at every step and every
    25."""
    from raocp_tpu_torch.parallel import sharding

    out = {}
    for name in ("demo", "uniform"):
        problem, x0 = _problem(name)
        solver = rt.Solver(problem, mesh=mesh, partition="flat",
                           device="cpu")
        fp = solver.flat
        sharding.reset_counters()
        out[f"{name}_lambda"] = solver.operator_norm_sq()
        out[f"{name}_power"] = [sharding.EXCHANGES, sharding.ALL_REDUCES]
        out[f"{name}_power_iters"] = solver.power_iterations
        out[f"{name}_stages"] = problem.tree.num_stages
        x0t = torch.as_tensor(x0, dtype=fp.sp.dtype)
        for every, unroll in ((1, 1), (25, 25)):
            z0, eta0 = fp.sp.zero_primal(), fp.sp.zero_dual()
            if fp.rank == 0:
                z0.x[0] = x0t
            sharding.reset_counters()
            solver_mod._run_cp(fp.sp, z0, eta0, x0t, 0.1, 0.1, 0.0,
                               50 if every > 1 else 49, check_every=every,
                               unroll=unroll)
            out[f"{name}_every{every}"] = [sharding.EXCHANGES,
                                           sharding.ALL_REDUCES]
            out[f"{name}_every{every}_bytes"] = sharding.EXCHANGE_BYTES
    return out, {}


def _counted_prox():
    """Count ``prox_f`` calls (the T evaluations) while a solve runs."""
    calls = {"n": 0}
    real = solver_mod.prox_f

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        solver_mod.prox_f = counting
        try:
            yield calls
        finally:
            solver_mod.prox_f = real
    return ctx()


def check_accel(mesh, args):
    """Anderson and SuperMann windows on the flat demo at the single
    device's step size: the T evaluations and iterates, for the pytest
    side to hold against the single-device windows."""
    solver, x0 = _flat_solver("demo", mesh)
    alpha = 0.999 / rt.Solver(_problem("demo")[0],
                              device="cpu").operator_norm_sq()
    out, arrays = {"alpha": alpha}, {}
    for accel, iters in (("anderson", ANDERSON_WINDOW),
                         ("supermann", SUPERMANN_WINDOW)):
        with _counted_prox() as calls:
            res = solver.solve(x0, max_iters=iters, tol=1e-12, alpha=alpha,
                               accel=accel)
        out[f"{accel}_evals"] = calls["n"]
        out[f"{accel}_iters"] = res.num_iters
        arrays.update(_global(res, accel))
    return out, arrays


def check_batch(mesh, args):
    """``solve_batch`` of the demo's three lanes on the flat layout."""
    solver, x0 = _flat_solver("demo", mesh)
    x0 = np.asarray(x0)
    res = solver.solve_batch(np.stack([s * x0 for s in BATCH_SCALES]),
                             **DEMO)
    arrays = {}
    for b, r in enumerate(res):
        arrays.update(_global(r, f"lane{b}"))
    return dict(iters=[r.num_iters for r in res],
                alpha=res[0].alpha), arrays


def check_chunked(mesh, args):
    """Chunks of 100 against the unchunked loop; a fault on every rank in
    the second chunk, retried; one that persists (a global-layout
    checkpoint written by rank 0)."""
    from raocp_tpu_torch.ops.sweep import DeviceFault

    solver, x0 = _flat_solver("demo", mesh)
    plain = solver.solve(x0, **CHUNKED)
    chunked = solver.solve(x0, chunk_iters=CHUNK, **CHUNKED)
    real_run = solver_mod._run_cp
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise DeviceFault("injected device fault")
        return real_run(*a, **kw)

    solver_mod._run_cp = flaky
    retried = solver.solve(x0, chunk_iters=CHUNK, **CHUNKED)
    calls["n"] = 0

    def dead(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise DeviceFault("injected persistent fault")
        return real_run(*a, **kw)

    solver_mod._run_cp = dead
    ckpt = os.path.join(args.out, "fault.npz")
    fault = _raised(lambda: solver.solve(x0, chunk_iters=CHUNK,
                                         checkpoint_on_fault=ckpt, **PROD))
    solver_mod._run_cp = real_run

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
        retried_iterate_diff=diff(retried, plain), fault=fault,
        checkpoint=ckpt), {}


def check_warm(mesh, args):
    """Warm starts across layouts on the 364-node tree: a flat partial
    solve resumed on the subtree layout (and, in pytest, on one device); a
    subtree partial solve and a single-device one resumed on the flat
    layout."""
    problem, x0 = _problem("uniform")
    flat, _ = _flat_solver("uniform", mesh)
    subtree = rt.Solver(problem, mesh=mesh, partition="subtree",
                        device="cpu")
    single = rt.Solver(problem, device="cpu").solve(x0, **PARTIAL)
    fpart = flat.solve(x0, **PARTIAL)
    path = os.path.join(args.out, "flat_partial.npz")
    if flat.flat.rank == 0:
        fpart.save_checkpoint(path)
    torch.distributed.barrier()
    z, eta, k = rt.SolverResult.load_checkpoint(path)
    on_subtree = subtree.solve(x0, warm_start=(z, eta), **RESUMED)
    spart = subtree.solve(x0, **PARTIAL)
    from_subtree = flat.solve(x0, warm_start=(spart.primal, spart.dual),
                              **RESUMED)
    from_single = flat.solve(x0, warm_start=(single.primal, single.dual),
                             **RESUMED)
    return dict(checkpoint_iters=k, rows=int(z.x.shape[0]),
                on_subtree_iters=on_subtree.num_iters,
                from_subtree_iters=from_subtree.num_iters,
                from_single_iters=from_single.num_iters,
                subtree_layout=subtree.subtree is not None), \
        {**_global(fpart, "fpart"), **_global(on_subtree, "on_subtree"),
         **_global(from_subtree, "from_subtree"),
         **_global(from_single, "from_single")}


def check_mpc(mesh, args):
    """``RiskAverseMPC(mesh=...)`` on a tree with no subtree frontier:
    every cached solver on the flat layout."""
    ctl, x0 = port_models.demo_mpc_controller(mesh=mesh, device="cpu",
                                              **RAGGED)
    run = ctl.run(x0, **MPC_RUN)
    flat = all(ctl.solver_for_mode(int(w))[0].flat is not None
               for w in run.modes[:-1])
    return dict(flat=flat, iterations=run.iterations.tolist(),
                modes=run.modes.tolist()), \
        {"mpc/states": run.states, "mpc/inputs": run.inputs}


def check_small(mesh, args):
    """The small stand-ins of other test files: ``partition="flat"`` on
    ``lqr_binary_problem`` and the per-mode solver of an MPC controller
    on a tree with no subtree frontier, each solved for SMALL_WINDOW."""
    problem, x0 = port_models.lqr_binary_problem()
    lqr = rt.Solver(problem, mesh=mesh, partition="flat", device="cpu")
    ragged, rx0 = _problem("ragged")
    ctl = rt.RiskAverseMPC(lambda v: ragged, np.eye(3), mesh=mesh,
                           device="cpu")
    mode0 = ctl.solver_for_mode(0)[0]
    return dict(flat=[lqr.flat is not None, mode0.flat is not None]), {
        **_global(lqr.solve(x0, **SMALL_WINDOW), "lqr"),
        **_global(mode0.solve(rx0, **SMALL_WINDOW), "mpc_mode0")}


def check_misconfig(mesh, args):
    """What still raises on a mesh, pointing at the flat layout."""
    problem, x0 = _problem("uniform")
    solver = rt.Solver(problem, mesh=mesh, partition="subtree",
                       device="cpu")
    return dict(
        pad_subtree=_raised(lambda: rt.Solver(
            problem, mesh=mesh, partition="subtree", pad_multiple=2,
            device="cpu")),
        ragged_subtree=_raised(lambda: rt.Solver(
            _problem("ragged")[0], mesh=mesh, partition="subtree",
            device="cpu")),
        accel_subtree=_raised(lambda: solver.solve(x0, max_iters=5,
                                                   accel="anderson")),
        batch_subtree=_raised(lambda: solver.solve_batch(
            np.stack([x0, x0]), max_iters=5))), {}


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


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# -- the tests -----------------------------------------------------------------

WORLD_CHECKS = ("ops", "layout", "demo", "loops", "ragged", "pad", "ghosts",
                "collectives", "accel", "batch", "chunked", "warm", "mpc",
                "misconfig")
WORLDS = (2, 3)
# checks whose numbers are a rank's own (the collectives: the bytes a
# rank sends)
PER_RANK = ("layout", "ghosts", "collectives")


def _jax():
    import jax  # noqa: F401  (the conftest set x64 and 8 CPU devices)
    import raocp_tpu as rj
    import raocp_tpu.models as jm
    from raocp_tpu.parallel import make_mesh
    return rj, jm, make_mesh


def _jax_flat_ops(name):
    """L, L' and one CP step of the JAX package's flat partition over 8
    devices (``tests/test_sharding.py``), from :func:`_inputs`'s arrays,
    real rows only."""
    import jax
    import jax.numpy as jnp
    from raocp_tpu.core.stacked import build_stacked as jbuild
    from raocp_tpu.ops.operator import ell, ell_t
    from raocp_tpu.parallel import shard_problem, shard_variables
    from raocp_tpu.solver import cp_iteration
    from raocp_tpu_torch.core.stacked import build_stacked

    rj, jm, make_mesh = _jax()
    problem, x0 = _problem(name, jm, rj)
    sp = jbuild(problem, pad_multiple=8)
    mesh = make_mesh(num_devices=8)
    sh = shard_problem(sp, mesh)
    port = build_stacked(_problem(name)[0], device="cpu")
    z, eta = _inputs(port)
    from raocp_tpu.core.variables import Dual, Primal
    zj = Primal(*map(jnp.asarray, _embed(z, sp.zero_primal())))
    ej = Dual(*map(jnp.asarray, _embed(eta, sp.zero_dual())))
    z_sh, e_sh = shard_variables(zj, mesh), shard_variables(ej, mesh)
    Lz = jax.jit(ell)(sh, z_sh)
    Lt = jax.jit(ell_t)(sh, e_sh)
    zn, en, Lzn, Ltn, err, derr = jax.jit(cp_iteration)(
        sh, z_sh, e_sh, Lz, Lt, STEP_ALPHA, STEP_ALPHA,
        jnp.asarray(x0, sp.dtype))
    out = {}
    for key, tree in (("L", Lz), ("Lt", Lt), ("zn", zn), ("en", en),
                      ("Lzn", Lzn), ("Ltn", Ltn)):
        out.update(_save(key, type(tree)(*map(np.asarray, tree))))
    out["err"], out["derr"] = np.asarray(err), np.asarray(derr)
    return out


def _port_ops(name, lanes=None):
    """The same L, L' and step on one device, at pad_multiple=1."""
    from raocp_tpu_torch.core.stacked import build_stacked
    from raocp_tpu_torch.ops.operator import ell, ell_t
    from raocp_tpu_torch.solver import _cp_residuals, _cp_step

    problem, x0 = _problem(name)
    sp = _variant(name, build_stacked(problem, device="cpu"))
    z, eta = _inputs(sp, lanes=lanes)
    z = rt.core.Primal(*(torch.as_tensor(v) for v in z))
    eta = rt.core.Dual(*(torch.as_tensor(v) for v in eta))
    x0t = torch.as_tensor(np.stack([x0] * lanes) if lanes else x0)
    Lz, Lt = ell(sp, z), ell_t(sp, eta)
    zn, en, Lzn, Ltn = _cp_step(sp, z, eta, Lz, Lt, STEP_ALPHA, STEP_ALPHA,
                                x0t)
    err, derr = _cp_residuals(sp, z, zn, eta, en, Lz, Lzn, Lt, Ltn,
                              STEP_ALPHA, STEP_ALPHA)
    out = {}
    for key, tree in (("L", Lz), ("Lt", Lt), ("zn", zn), ("en", en),
                      ("Lzn", Lzn), ("Ltn", Ltn)):
        out.update(_save(key, type(tree)(*(v.numpy() for v in tree))))
    out["err"], out["derr"] = err.numpy(), derr.numpy()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The D = 2 and 3 worlds, started together; meanwhile the JAX flat
    partition's runs and the port's single-device references."""
    base = tmp_path_factory.mktemp("torch_flat")
    spawned = {D: World(D, WORLD_CHECKS, str(base / f"w{D}"),
                        script=os.path.abspath(__file__)) for D in WORLDS}
    rj, jm, make_mesh = _jax()
    jax_res = {"ops": {name: _jax_flat_ops(name) for name in JAX_OPS_CASES}}
    mesh = make_mesh(num_devices=8)
    for key, name, opts in (("demo", "demo", DEMO), ("relax", "demo", RELAX),
                            ("ragged", "ragged", DEMO)):
        problem, x0 = _problem(name, jm, rj)
        solver = rj.Solver(problem, mesh=mesh,
                           partition="flat" if key != "ragged" else "auto")
        assert solver.subtree is None
        jax_res[key] = solver.solve(x0, **opts)
    for key in ("demo", "prod", "relax", "ragged", "pad", "batch", "warm",
                "mpc"):
        _single(key)
    out = {D: w.wait() for D, w in spawned.items()}
    out["jax"] = jax_res
    return out


_SINGLE = {}


def _single(key, alpha=None):
    """The port's single-device runs the flat ones are held against."""
    if (key, alpha) in _SINGLE:
        return _SINGLE[key, alpha]
    demo, x0 = _problem("demo")
    if key == "batch":
        solver = rt.Solver(demo, device="cpu")
        out = [solver.solve(s * np.asarray(x0), **DEMO)
               for s in BATCH_SCALES]
    elif key == "mpc":
        ctl, x0 = port_models.demo_mpc_controller(device="cpu", **RAGGED)
        out = ctl.run(x0, **MPC_RUN)
    elif key == "warm":
        problem, ux0 = _problem("uniform")
        part = rt.Solver(problem, device="cpu").solve(ux0, **PARTIAL)
        out = rt.Solver(problem, device="cpu").solve(
            ux0, warm_start=(part.primal, part.dual), **RESUMED)
    elif key == "ragged":
        problem, rx0 = _problem("ragged")
        out = rt.Solver(problem, device="cpu").solve(rx0, **DEMO)
    else:
        opts = {"demo": DEMO, "prod": PROD, "relax": RELAX,
                "pad": WINDOW}[key]
        out = rt.Solver(demo, device="cpu").solve(x0, alpha=alpha, **opts)
    _SINGLE[key, alpha] = out
    return out


def _rank0(worlds, D, check):
    return worlds[D][0][0][check]


def _assert_iterates(arrays, prefix, res, atol):
    for tree in (res.primal, res.dual):
        for k, v in tree._asdict().items():
            v = np.asarray(v)
            got = arrays[f"{prefix}/{k}"]
            np.testing.assert_allclose(got, v[:got.shape[0]], rtol=0,
                                       atol=atol, err_msg=f"{prefix}/{k}")


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_import_no_jax_and_agree(worlds, D):
    """No rank imported JAX; every rank reports the same numbers and
    returns the same global arrays, bit for bit."""
    first, first_arr = worlds[D][0]
    for res, arr in worlds[D]:
        assert res["imports_clean"]
        for check in WORLD_CHECKS:
            if check in PER_RANK:
                continue
            a = {k: v for k, v in first[check].items() if k != "seconds"}
            b = {k: v for k, v in res[check].items() if k != "seconds"}
            assert a == b, check
        for k in first_arr:
            np.testing.assert_array_equal(arr[k], first_arr[k], err_msg=k)


def _ops_close(got, want, tag, atol=1e-12):
    for k, v in want.items():
        g = got[f"{tag}/{k}"]
        v = np.asarray(v)
        if v.ndim and k not in ("err", "derr"):
            v = v[:g.shape[0]] if not tag.endswith("_lanes") \
                else v[:, :g.shape[1]]
        np.testing.assert_allclose(g, v, rtol=0, atol=atol,
                                   err_msg=f"{tag}/{k}")


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("case", JAX_OPS_CASES)
def test_operator_and_step_match_jax_flat(worlds, D, case):
    """L, L' and one CP step with its residuals on the flat blocks, from
    the same inputs, against the JAX package's flat partition over 8
    devices: the demo, L2Ball risk with a polyhedral nonleaf constraint,
    and Wasserstein risk; within 1e-12."""
    got = worlds[D][0][1]
    _ops_close(got, worlds["jax"]["ops"][case], case)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("case", [c for c in OPS_CASES
                                  if c not in JAX_OPS_CASES]
                         + ["demo_lanes", "chain_lanes"])
def test_operator_and_step_match_single_device(worlds, D, case):
    """The other fixtures (a ragged tree with no frontier, mode-constant
    chain stages, the SOC network, the uniform tree, the unstacked,
    unfused and dense-modal branches of L and L', two lanes) against the
    port's single-device ops; within 1e-12."""
    got = worlds[D][0][1]
    lanes = LANES if case.endswith("_lanes") else None
    _ops_close(got, _port_ops(case.replace("_lanes", ""), lanes), case)


@pytest.mark.parametrize("D", WORLDS)
def test_rank_holds_its_blocks_and_planned_halo(worlds, D):
    """Every node-leading field of a rank's problem is its row block, its
    halo tables cover its planned windows, and every exchange of a CP step
    brings exactly its planned windows, none of them a whole space."""
    for res, _ in worlds[D]:
        for name, got in res["layout"].items():
            if name == "seconds":
                continue
            assert got["not_a_block"] == []
            assert [b * D for b in got["blocks"]] == got["global_rows"]
            cw = got["child_window"][1] - got["child_window"][0]
            rows = got["table_rows"]
            for key in ("QRm_c", "sqrtQ_c", "sqrtR_c", "ABm_c"):
                assert rows[key] == cw, (name, key)
            assert rows["ABm_nl"] == got["nl_rows"]
            assert rows["anc_nl"] == got["q_block"]
            assert got["windows_as_planned"]
            assert got["largest_window"] < got["num_nodes"]


@pytest.mark.parametrize("D", WORLDS)
def test_padding_keeps_ghost_rows_zero(worlds, D):
    """Ghost rows of every rank's blocks stay exactly zero through 50 loop
    steps (the padding changes no real row: the operator tests)."""
    rows = 0
    for res, _ in worlds[D]:
        g = res["ghosts"]
        assert g["demo_ghost_max"] == 0.0 and g["uniform_ghost_max"] == 0.0
        rows += g["demo_ghost_rows"] + g["uniform_ghost_rows"]
    assert rows > 0


@pytest.mark.parametrize("D", WORLDS)
def test_demo_937_flat(worlds, D):
    """THE gate on the flat layout: 937 iterations, the reference's
    residuals, JAX's flat run's iterates and histories within 1e-10, the
    port's single-device iterates within 1e-12, validate below 1e-10;
    results in the global layout (real rows)."""
    got = _rank0(worlds, D, "demo")
    arrays = worlds[D][0][1]
    want = worlds["jax"]["demo"]
    assert got["flat"] and got["converged"]
    assert got["iters"] == want.num_iters == 937
    np.testing.assert_allclose(got["xi"], [9.9508e-4, 9.4106e-4, 9.5599e-4],
                               rtol=1e-3)
    _assert_iterates(arrays, "demo", want, 1e-10)
    np.testing.assert_allclose(arrays["demo/xi_history"], want.xi_history,
                               rtol=0, atol=1e-10)
    single = _single("demo")
    assert got["rows"] == single.primal.x.shape[0]
    assert got["alpha"] == pytest.approx(single.alpha, rel=1e-12)
    _assert_iterates(arrays, "demo", single, 1e-12)
    assert _hist_diff(arrays["demo/xi_history"], single.xi_history) \
        <= 1e-12 * np.abs(single.xi_history).max()
    assert got["validate"] < 1e-10


@pytest.mark.parametrize("D", WORLDS)
def test_production_loop_flat(worlds, D):
    """check_every=25, unroll=25: the single solve's count and iterates."""
    got = _rank0(worlds, D, "loops")
    single = _single("prod")
    assert got["prod_converged"] and got["prod_iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], "prod", single, 1e-12)
    assert _hist_diff(worlds[D][0][1]["prod/xi_history"],
                      single.xi_history) <= 1e-12


@pytest.mark.parametrize("D", WORLDS)
def test_relax_adaptive_flat(worlds, D):
    """relax=1.5 with adaptive steps: JAX's flat count and iterates (1e-10)
    and the single solve's (1e-12)."""
    got = _rank0(worlds, D, "loops")
    want = worlds["jax"]["relax"]
    single = _single("relax")
    assert got["relax_converged"]
    assert got["relax_iters"] == want.num_iters == single.num_iters
    _assert_iterates(worlds[D][0][1], "relax", want, 1e-10)
    _assert_iterates(worlds[D][0][1], "relax", single, 1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_ragged_tree_auto_takes_flat(worlds, D):
    """A tree with no subtree frontier under "auto": the flat layout,
    JAX's count and iterates (1e-10), the single solve's (1e-12)."""
    got = _rank0(worlds, D, "ragged")
    want = worlds["jax"]["ragged"]
    single = _single("ragged")
    assert got["flat"] and got["converged"]
    assert got["iters"] == want.num_iters == single.num_iters
    _assert_iterates(worlds[D][0][1], "ragged", want, 1e-10)
    _assert_iterates(worlds[D][0][1], "ragged", single, 1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_pad_multiple_on_a_mesh(worlds, D):
    """pad_multiple=4: the flat layout, padded to lcm(4, D); the single
    solve's window."""
    got = _rank0(worlds, D, "pad")
    single = _single("pad")
    assert got["flat"]
    step = int(np.lcm(4, D))
    assert all(p % step == 0 for p in got["pads"])
    assert got["iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], "pad", single, 1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_collectives_pinned(worlds, D):
    """Per CP step 2 (num_stages - 1) + 3 exchanges (the sweep's two a
    nonleaf stage, L's one, L''s two) and no all-reduce; per check two
    more exchanges (L' of xi_2) and one all-reduce: 2 (num_stages - 1) + 6
    collectives a step checked at every step, whatever the node count.
    The loop's first L and L' add three exchanges; the power iteration
    three a step and two all-reduces, plus one. Its lambda is the single
    device's."""
    for got, _ in worlds[D]:
        got = got["collectives"]
        for name in ("demo", "uniform"):
            ns = got[f"{name}_stages"]
            step = 2 * (ns - 1) + 3
            assert got[f"{name}_every1"] == [3 + 50 * (step + 2), 50]
            assert got[f"{name}_every25"] == [3 + 50 * step + 2 * 2, 2]
            assert sum(got[f"{name}_every1"]) / 50 < 2 * (ns - 1) + 6 + 0.1
            k = got[f"{name}_power_iters"]
            assert got[f"{name}_power"] == [3 * k, 1 + 2 * k]
            assert got[f"{name}_every1_bytes"] > 0
            lam = rt.Solver(_problem(name)[0],
                            device="cpu").operator_norm_sq()
            assert got[f"{name}_lambda"] == pytest.approx(lam, rel=1e-12)


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("accel,iters", [("anderson", ANDERSON_WINDOW),
                                         ("supermann", SUPERMANN_WINDOW)])
def test_accelerated_window_flat(worlds, D, accel, iters):
    """Anderson and SuperMann on the flat demo: over a window, the single
    device's T evaluations, iterates (1e-10) and count at its step size
    (the accelerators amplify rounding, so converged counts are not
    compared)."""
    got = _rank0(worlds, D, "accel")
    problem, x0 = _problem("demo")
    with _counted_prox() as calls:
        single = rt.Solver(problem, device="cpu").solve(
            x0, max_iters=iters, tol=1e-12, alpha=got["alpha"], accel=accel)
    assert got[f"{accel}_evals"] == calls["n"]
    assert got[f"{accel}_iters"] == single.num_iters
    _assert_iterates(worlds[D][0][1], accel, single, 1e-10)


@pytest.mark.parametrize("D", WORLDS)
def test_solve_batch_flat(worlds, D):
    """The demo's three lanes in one batch: lane 0 takes 937 iterations,
    every lane its single solve's count and iterates (1e-12)."""
    got = _rank0(worlds, D, "batch")
    arrays = worlds[D][0][1]
    singles = _single("batch")
    assert got["iters"][0] == 937
    assert got["iters"] == [r.num_iters for r in singles]
    for b, single in enumerate(singles):
        _assert_iterates(arrays, f"lane{b}", single, 1e-12)
        assert _hist_diff(arrays[f"lane{b}/xi_history"],
                          single.xi_history) <= 1e-12 * np.abs(
            single.xi_history).max()


@pytest.mark.parametrize("D", WORLDS)
def test_chunked_and_fault_recovered_flat(worlds, D):
    """Chunks of 100: the unchunked loop's count, history and iterates; a
    fault on every rank retried; a persistent one writes a global-layout
    checkpoint after the first chunk that a single-device solve
    resumes."""
    got = _rank0(worlds, D, "chunked")
    assert got["chunked_iters"] == got["plain_iters"] == 300
    assert got["chunked_history_diff"] <= 1e-12
    assert got["chunked_iterate_diff"] <= 1e-12
    assert got["retried_iters"] == got["plain_iters"]
    assert got["retried_history_diff"] <= 1e-12
    assert got["retried_iterate_diff"] <= 1e-12
    assert got["fault"].startswith("RuntimeError") and "saved to" \
        in got["fault"]
    z, eta, k = rt.SolverResult.load_checkpoint(got["checkpoint"])
    problem, x0 = _problem("demo")
    assert k == CHUNK and z.x.shape[0] == problem.tree.num_nodes
    resumed = rt.Solver(problem, device="cpu").solve(
        x0, warm_start=(z, eta), **DEMO)
    assert resumed.converged
    assert abs(resumed.num_iters + CHUNK - _single("demo").num_iters) <= 1


@pytest.mark.parametrize("D", WORLDS)
def test_checkpoint_warm_start_across_layouts(worlds, D):
    """A flat partial solve's checkpoint (150 iterations) resumes on the
    subtree layout and on one device; subtree and single-device partial
    solves resume on the flat layout: each takes the single warm solve's
    next 200 iterations (1e-12)."""
    got = _rank0(worlds, D, "warm")
    arrays = worlds[D][0][1]
    warm = _single("warm")
    problem, x0 = _problem("uniform")
    assert got["subtree_layout"] and got["checkpoint_iters"] == 150
    assert got["rows"] == problem.tree.num_nodes
    for key in ("on_subtree", "from_subtree", "from_single"):
        assert got[f"{key}_iters"] == warm.num_iters, key
        _assert_iterates(arrays, key, warm, 1e-12)
    zp = rt.core.Primal(*(arrays[f"fpart/{k}"]
                          for k in rt.core.Primal._fields))
    ep = rt.core.Dual(*(arrays[f"fpart/{k}"] for k in rt.core.Dual._fields))
    resumed = rt.Solver(problem, device="cpu").solve(
        x0, warm_start=(zp, ep), **RESUMED)
    assert resumed.num_iters == warm.num_iters


@pytest.mark.parametrize("D", WORLDS)
def test_mpc_ragged_tree_with_mesh(worlds, D):
    """``RiskAverseMPC(mesh=...)`` on a tree with no subtree frontier:
    every cached solver flat, and the single-device controller's modes,
    counts, states and inputs."""
    got = _rank0(worlds, D, "mpc")
    arrays = worlds[D][0][1]
    want = _single("mpc")
    assert got["flat"]
    assert got["modes"] == want.modes.tolist()
    assert got["iterations"] == want.iterations.tolist()
    np.testing.assert_allclose(arrays["mpc/states"], want.states, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(arrays["mpc/inputs"], want.inputs, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("D", WORLDS)
def test_subtree_refusals_point_at_flat(worlds, D):
    """``pad_multiple``, a tree with no frontier, ``accel`` and
    ``solve_batch`` still raise under ``partition="subtree"``, as in JAX,
    and name the flat partition."""
    got = _rank0(worlds, D, "misconfig")
    for case in ("pad_subtree", "ragged_subtree", "accel_subtree",
                 "batch_subtree"):
        assert got[case].startswith("ValueError") \
            and "partition='flat'" in got[case], got[case]
