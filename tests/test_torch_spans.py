"""The port's own timing: host spans at the solve path's layer boundaries
(``ops.cond.span``: ``raocp.solve``, ``raocp.loop.drive``,
``raocp.loop.launch``, ``raocp.setup.build``, ``raocp.setup.power``) and
the device loops' marks of the card's clock, read with each replay's flag
(``ops.cond.Flags``). On the CPU no period is a replay, so the launch
and device keys stay 0; the marks' arithmetic is held here on stamps set
by hand. This file imports no JAX."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu_torch as rt  # noqa: E402
from raocp_tpu_torch import accel  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402
from raocp_tpu_torch.models import random_network_problem  # noqa: E402
from raocp_tpu_torch.ops import cond  # noqa: E402

TINY = dict(num_states=4, num_inputs=2, num_modes=2, num_stages=3,
            stopping_time=3)
DEVICE_KEYS = ("launch_seconds", "timed_periods", "period_device_seconds",
               "gap_device_seconds")


@pytest.fixture(scope="module")
def tiny():
    problem, x0 = random_network_problem(**TINY)
    solver = rt.Solver(problem, device="cpu")
    solver.operator_norm_sq()
    return solver, np.asarray(x0)


def _counts():
    return dict(loop=dict(solver_mod.LOOP_COUNTS),
                accel=dict(accel.LOOP_COUNTS))


def _ran(before):
    now = _counts()
    return {part: {k: now[part][k] - before[part][k] for k in now[part]}
            for part in now}


@pytest.mark.parametrize("method", [None, "supermann", "batch"])
def test_solve_moves_the_host_spans(tiny, method):
    """A device-loop solve on the CPU (plain, SuperMann, or a batch of
    two lanes through ``solve_batch``): its span and its loop's drive
    move, in the loop's own dict; no replay, so no launch and no mark; the
    solve holds its drives."""
    solver, x0 = tiny
    before = _counts()
    opts = dict(max_iters=300, tol=3e-2, check_every=5)
    if method == "batch":
        results = solver.solve_batch(np.stack([x0, -x0]), **opts)
    else:
        results = [solver.solve(x0, accel=method, **opts)]
    ran = _ran(before)
    own, other = (("accel", "loop") if method == "supermann"
                  else ("loop", "accel"))
    assert all(res.num_iters > 0 for res in results)
    assert ran[own]["periods"] > 0
    assert ran["loop"]["solve_seconds"] > 0
    assert ran[own]["drive_seconds"] > 0
    assert ran[other]["drive_seconds"] == 0
    for part in ran:
        for key in DEVICE_KEYS:
            assert ran[part][key] == 0, (part, key)
    assert ran["loop"]["solve_seconds"] >= ran["loop"]["drive_seconds"] \
        + ran["accel"]["drive_seconds"]


def test_build_and_power_spans():
    """``raocp.setup.build`` moves once for each Solver, and
    ``raocp.setup.power`` on the first ``operator_norm_sq()`` alone (the
    later ones are memoised)."""
    problem, _ = random_network_problem(**TINY)
    for _ in range(2):
        before = dict(solver_mod.LOOP_COUNTS)
        solver = rt.Solver(problem, device="cpu")
        built = solver_mod.LOOP_COUNTS["build_seconds"] \
            - before["build_seconds"]
        assert built > 0
        assert solver_mod.LOOP_COUNTS["power_seconds"] \
            == before["power_seconds"]
        lam = solver.operator_norm_sq()
        power = solver_mod.LOOP_COUNTS["power_seconds"]
        assert power > before["power_seconds"]
        assert solver.operator_norm_sq() == lam
        assert solver_mod.LOOP_COUNTS["power_seconds"] == power
        assert solver_mod.LOOP_COUNTS["build_seconds"] \
            == before["build_seconds"] + built


@pytest.mark.parametrize("method", ["anderson", "supermann"])
def test_eager_loops_move_the_accel_counts(tiny, method):
    """An accelerated loop that does not capture (``cond.captures`` false,
    as on the CPU and on a partition) adds its periods, host reads,
    iterations and T evaluations to ``accel.LOOP_COUNTS``, but no capture,
    replay, replayed T evaluation or timed period."""
    solver, x0 = tiny
    assert not cond.captures(solver.stacked)
    before = dict(accel.LOOP_COUNTS)
    res = solver.solve(x0, max_iters=60, tol=1e-12, accel=method)
    ran = {k: accel.LOOP_COUNTS[k] - before[k] for k in before}
    period = accel.PERIOD_CHECK_EVERY_1
    assert ran["iterations"] == res.num_iters == 61
    assert ran["periods"] == -(-61 // period)
    assert ran["host_reads"] == ran["periods"] + 2
    assert ran["t_evals"] > ran["iterations"]
    for key in ("captures", "replays", "replayed_t_evals", "capture_seconds",
                *DEVICE_KEYS):
        assert ran[key] == 0, key


@pytest.mark.parametrize("where", ["cpu", "card", "card_partition"])
def test_only_a_single_card_captures(where):
    """The loops capture their periods as CUDA graphs on a single device
    on a card, and nowhere else: not on the CPU, and not on a partition,
    whose collectives are staged on the host."""
    import types

    sp = types.SimpleNamespace(
        device=torch.device("cpu" if where == "cpu" else "cuda"),
        spmd_group=object() if where == "card_partition" else None)
    assert cond.captures(sp) == (where == "card")


def test_span_counts_a_block_that_raises():
    """A span adds its seconds also where its block raises."""
    counts = dict(t=0.0)
    with pytest.raises(RuntimeError):
        with cond.span("raocp.test", counts, "t"):
            raise RuntimeError("inside")
    assert counts["t"] > 0


def test_spans_land_in_a_trace(tiny, tmp_path):
    """A ``torch.profiler`` trace around a solve holds the solve's span
    and its loop's drive inside it; ``solve(profile_dir=...)``, whose
    profiler starts inside the solve, the drive."""
    from torch.profiler import ProfilerActivity, profile

    solver, x0 = tiny
    opts = dict(max_iters=50, tol=1e-12, check_every=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.solve(x0, **opts)
    path = os.path.join(tmp_path, "outer.json")
    prof.export_chrome_trace(path)
    solver.solve(x0, profile_dir=str(tmp_path), **opts)
    spans = []
    for name in (path, os.path.join(tmp_path, "trace.json")):
        with open(name) as fh:
            events = json.load(fh)["traceEvents"]
        spans.append({ev["name"]: ev for ev in events
                      if ev.get("cat") == "user_annotation"})
    solve, drive = spans[0]["raocp.solve"], spans[0]["raocp.loop.drive"]
    assert solve["ts"] <= drive["ts"]
    assert drive["ts"] + drive["dur"] <= solve["ts"] + solve["dur"]
    assert "raocp.loop.drive" in spans[1]


def _marked_flags(counts):
    """Flags on the CPU with the card's stamps set by hand: ``stamp(n,
    start, end)`` posts period ``n`` as a replay whose marks read (start,
    end) ns."""
    flags = cond.Flags(torch.device("cpu"), counts)
    flags.stamps = torch.zeros((2, 2), dtype=torch.int64)
    running = torch.tensor(True)

    def stamp(n, start, end, timed=True):
        flags.post(n, running, timed=timed)
        flags.stamps[n % 2] = torch.tensor([start, end])

    return flags, stamp


def test_flags_time_replays_and_the_gaps_between_them():
    """A replay's read adds its period and the gap since the replay read
    before it in the same call; a call's first period and a period after
    an untimed one add no gap; an untimed period adds nothing."""
    counts = dict(period_device_seconds=0.0, gap_device_seconds=0.0,
                  timed_periods=0)
    flags, stamp = _marked_flags(counts)
    # a call: periods 0-2 replayed, 1,000 ns each, gaps of 50 and 70 ns
    for n, (a, b) in enumerate([(0, 1000), (1050, 2050), (2120, 3120)]):
        stamp(n, a, b)
        assert bool(flags.read(n))
    assert counts["timed_periods"] == 3
    assert counts["period_device_seconds"] == pytest.approx(3e-6)
    assert counts["gap_device_seconds"] == pytest.approx(120e-9)
    # the next call: its first period adds no gap from the last call's
    stamp(0, 10_000, 11_000)
    flags.read(0)
    assert counts["gap_device_seconds"] == pytest.approx(120e-9)
    # an untimed period (a capture, an eager one) adds nothing, and the
    # replay after it no gap
    stamp(1, 0, 0, timed=False)
    flags.read(1)
    stamp(2, 12_000, 12_500)
    flags.read(2)
    assert counts["timed_periods"] == 5
    assert counts["period_device_seconds"] == pytest.approx(4.5e-6)
    assert counts["gap_device_seconds"] == pytest.approx(120e-9)


def test_drive_is_one_span(tiny, monkeypatch):
    """Each drive of the CP and accelerated loops (``ops.cond.drive``;
    a chunked solve drives once a chunk) is one ``raocp.loop.drive`` span,
    and the power iteration's drive is none: its counts hold no key of a
    drive."""
    from torch.profiler import ProfilerActivity, profile

    solver, x0 = tiny
    drive, calls = cond.drive, []

    def counted(*args, **kw):
        calls.append(args)
        return drive(*args, **kw)

    monkeypatch.setattr(cond, "drive", counted)
    problem, _ = random_network_problem(**TINY)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.solve(x0, max_iters=300, tol=1e-12, check_every=5,
                     chunk_iters=100)
        chunked = len(calls)
        solver.solve(x0, max_iters=60, tol=1e-12, accel="supermann")
        accelerated = len(calls)
        rt.Solver(problem, device="cpu").operator_norm_sq()
    assert chunked == 3 and accelerated == 4 and len(calls) == 5
    spans = [ev for ev in prof.events() if ev.name == "raocp.loop.drive"]
    assert len(spans) == accelerated
    assert set(solver_mod.POWER_COUNTS) == {"periods", "host_reads",
                                            "iterations"}
