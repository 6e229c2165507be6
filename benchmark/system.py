"""The system under test, ``raocp_tpu_torch``, as the benchmark drives it:
the problem of a configuration built from the benchmark's own arrays
(:mod:`benchmark.reference.problem`) through the package's public API, a
solver made and warmed up inside a span of set-up, and the package's own
counters read around a window. Only the traffic modules import this
module."""

import time

import numpy as np
import torch

import raocp_tpu_torch as rt
from raocp_tpu_torch import accel as rt_accel
from raocp_tpu_torch import solver as rt_solver


def build_problem(config: dict, plant, v) -> "rt.RAOCP":
    """The configuration's RAOCP rooted at the initial distribution ``v``:
    per mode (A, B) and costs (Q I, R I), P I at the leaves, AVaR at every
    nonleaf node, and by its ``constraint`` boxes (``"box"``) or balls
    centred at 0 (``"ball"``, of its ``radius``) on [x; u] and on the leaf
    states."""
    n, m = config["num_states"], config["num_inputs"]
    tree = rt.MarkovChainScenarioTreeFactory(
        plant.P, v, config["num_stages"], config["stopping_time"]).create()
    nl, lf = rt.Nonleaf(), rt.Leaf()
    modes = plant.A.shape[0]
    if config["constraint"] == "ball":
        nl_set = rt.Ball(nl, config["radius"])
        lf_set = rt.Ball(lf, config["radius"])
    else:
        lo = np.concatenate([np.full(n, -config["x_limit"]),
                             np.full(m, -config["u_limit"])])
        x_lo = np.full(n, -config["x_limit"])
        nl_set = rt.Rectangle(nl, lo, -lo)
        lf_set = rt.Rectangle(lf, x_lo, -x_lo)
    return (rt.RAOCP(scenario_tree=tree)
            .with_markovian_dynamics([rt.Dynamics(plant.A[w], plant.B[w])
                                      for w in range(modes)])
            .with_markovian_nonleaf_costs(
                [rt.Quadratic(nl, config["Q"] * np.eye(n),
                              config["R"] * np.eye(m))
                 for _ in range(modes)])
            .with_all_leaf_costs(rt.Quadratic(lf, config["P"] * np.eye(n)))
            .with_all_risks(rt.AVaR(config["alpha"]))
            .with_all_nonleaf_constraints(nl_set)
            .with_all_leaf_constraints(lf_set))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device) -> float:
    """Seconds that ``fn()`` takes, the device synchronised at both ends:
    the shorter of two runs, so that a hiccup of one run (an allocation,
    the host's thread descheduled) is not taken for the call's."""
    walls = []
    for _ in range(2):
        sync(device)
        tic = time.perf_counter()
        fn()
        sync(device)
        walls.append(time.perf_counter() - tic)
    return min(walls)


def make_solver(problem, config: dict, device, spans: list):
    """``Solver(problem)`` with its step size, the whole inside one span of
    ``spans`` (the construction: the offline factorisation, the upload,
    the power iteration)."""
    sync(device)
    tic = time.perf_counter()
    solver = rt.Solver(problem, dtype=getattr(torch, config["dtype"]),
                       offline=config["offline"], device=device)
    solver.operator_norm_sq()
    sync(device)
    spans.append(time.perf_counter() - tic)
    return solver


def counters() -> dict:
    """The package's own counts, summed since import: the plain device
    loop's (``solver.LOOP_COUNTS``) and the accelerated loops'
    (``accel.LOOP_COUNTS``)."""
    return dict(loop=dict(rt_solver.LOOP_COUNTS),
                accel=dict(rt_accel.LOOP_COUNTS))


def delta(before: dict, after: dict) -> dict:
    return {part: {k: after[part][k] - before[part][k]
                   for k in after[part]} for part in after}


def result_record(res, x0) -> dict:
    """What the benchmark keeps of a solve: its answer (the final iterate,
    host arrays), its initial state and its iterations."""
    return dict(x0=np.asarray(x0, dtype=np.float64),
                primal={k: np.asarray(v) for k, v in res.primal._asdict()
                        .items()},
                dual={k: np.asarray(v) for k, v in res.dual._asdict()
                      .items()},
                num_iters=int(res.num_iters))
