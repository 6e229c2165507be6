"""Partitioned CP at 1, 2, 4, ... ranks, one process a rank, for both
partitions (counterpart of the JAX package's ``scripts/bench_scaling.py``
and ``scripts/bench_scaling_multiproc.py``, merged: in the port a rank is
a process, so the multi-process model is the only one).

    python -m raocp_tpu_torch.scripts.bench_scaling [--ranks 1,2,4]
        [--partitions subtree,flat] [--num-stages 8] [--num-states 50]
        [--iters 500] [--pin] [--device cpu]

The problem: ``random_network_problem`` with ``--num-states`` states, half
as many inputs, a 3-mode chain fully branched for ``--num-stages`` stages
(9,841 nodes at 8). Each row runs ``--iters`` CP steps at ``check_every=25,
unroll=25`` with the JAX script's fixed step 0.01 and tolerance 0 (every
step runs), after a warm-up of 25 steps. One rank is the partition-free
single-device solve in one process, the baseline of every row; more
ranks run ``Solver(mesh=..., partition=...)`` over a gloo group on
localhost, each rank one process (with ``--pin`` on one core of its own,
by rank; every CPU rank runs one torch thread, the JAX script's
single-threaded model). One JSON line per (partition, ranks): ms a step
and iterations per second (the ranks' mean), speedup and efficiency
against the one-rank row, the all-reduces and halo exchanges a step, the
bytes a rank sends a step and the host ms in the collectives, read from
the counters of ``raocp_tpu_torch.parallel.sharding``, beside the counts
the partition's plan gives (:func:`planned_collectives`, checked equal),
and the largest distance of the result from the single device's, relative
to each leaf's largest entry (checked in float64).

Ranks run on the card, every rank on the one card (gloo stages the
collectives through the host); ``--device cpu`` runs them on the CPU, the
JAX script's multi-process proxy. On one host the ranks share its cores
or its card, so these numbers are a collective budget and a CPU proxy, not
a scaling figure.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["FRONTIER_CROSSINGS", "planned_collectives", "run_rank",
           "run_scaling"]

CHECK_EVERY = 25
ALPHA = 0.01
# the subtree partition's all-reduces: each child reduction over the
# frontier stage is one (ops.operator._frontier_psum). L' makes one (its
# child sum of e3 / e4); prox_f three (the sweep's [A | B]'q sum, the
# kernel projection's child slots and its child sum); L none. A residual
# check adds its L' and one all-reduce of the six norms.
FRONTIER_CROSSINGS = {"ell": 0, "ell_t": 1, "prox_f": 3}
# float64 partitioned results against the single device's: summation
# orders alone (each leaf relative to its largest entry)
F64_REL = 1e-9
RANK_TIMEOUT = 3600
_ROOT = Path(__file__).resolve().parents[2]


def problem(num_stages: int, num_states: int):
    from raocp_tpu_torch import models
    return models.random_network_problem(
        num_states=num_states, num_inputs=num_states // 2, num_modes=3,
        num_stages=num_stages, stopping_time=num_stages)


def planned_collectives(partition: str, tree_stages: int,
                        iters: int) -> dict:
    """The all-reduces and halo exchanges a solve of ``iters`` steps from
    the zero start makes on ``partition`` ("none", "subtree" or "flat"),
    from the partition's plan: the loop's first L and L', then per step
    prox_f, L and L', per check one more L' and the norms' all-reduce.
    The flat plan (``parallel/flat.py``): L one exchange, L' two, prox_f
    two a nonleaf stage (``tree_stages - 1`` of them)."""
    checks = iters // CHECK_EVERY
    if partition == "none":
        return dict(all_reduces=0, exchanges=0)
    if partition == "subtree":
        f = FRONTIER_CROSSINGS
        return dict(all_reduces=f["ell"] + f["ell_t"]
                    + iters * (f["prox_f"] + f["ell"] + f["ell_t"])
                    + checks * (f["ell_t"] + 1), exchanges=0)
    step = 2 * (tree_stages - 1) + 1 + 2
    return dict(all_reduces=checks, exchanges=3 + iters * step + checks * 2)


def run_rank(args) -> dict:
    """One rank's row (the whole of a one-rank run): the solve's rate, its
    collectives a step and its peak memory; rank 0 writes the result's
    leaves to ``args.out``."""
    if args.pin:
        os.sched_setaffinity(0, {args.rank % os.cpu_count()})
    if args.device == "cpu":
        torch.set_num_threads(1)
    from raocp_tpu_torch.parallel import sharding
    from raocp_tpu_torch.scripts.bench_configs import (card, peak_mb,
                                                       reset_peak)
    from raocp_tpu_torch.solver import Solver

    spec, x0 = problem(args.num_stages, args.num_states)
    dtype = getattr(torch, args.dtype)
    if args.partition == "none":
        solver = Solver(spec, dtype=dtype, device=args.device)
        device = solver.stacked.device
    else:
        sharding.initialize_distributed(
            "gloo", init_method=f"tcp://127.0.0.1:{args.port}",
            world_size=args.world, rank=args.rank, timeout=RANK_TIMEOUT)
        mesh = sharding.make_mesh(args.device)
        solver = Solver(spec, dtype=dtype, mesh=mesh,
                        partition=args.partition, device=args.device)
        device = (solver.subtree or solver.flat).sp.device
    opts = dict(tol=0.0, alpha=ALPHA, check_every=CHECK_EVERY,
                unroll=CHECK_EVERY)
    solver.solve(x0, max_iters=CHECK_EVERY, **opts)
    sharding.reset_counters()
    reset_peak(device)
    res = solver.solve(x0, max_iters=args.iters, **opts)
    it = res.num_iters
    row = dict(
        rank=args.rank, iters=it, seconds=res.solve_time,
        ms_per_step=1e3 * res.solve_time / it,
        iters_per_s=it / res.solve_time,
        all_reduces=sharding.ALL_REDUCES, exchanges=sharding.EXCHANGES,
        all_reduce_bytes_per_step=sharding.ALL_REDUCE_BYTES / it,
        exchange_bytes_per_step=sharding.EXCHANGE_BYTES / it,
        all_reduce_ms_per_step=1e3 * sharding.ALL_REDUCE_SECONDS / it,
        exchange_ms_per_step=1e3 * sharding.EXCHANGE_SECONDS / it,
        wait_ms_per_step=1e3 * (sharding.ALL_REDUCE_WAIT_SECONDS
                                + sharding.EXCHANGE_WAIT_SECONDS) / it,
        max_memory_allocated_mb=peak_mb(device), device=str(device),
        card=card(device), dtype=str(dtype), num_nodes=spec.tree.num_nodes)
    if args.rank == 0:
        np.savez(os.path.join(args.out, f"{args.partition}{args.world}.npz"),
                 **{f"{tree}_{k}": np.asarray(v)
                    for tree, t in (("primal", res.primal),
                                    ("dual", res.dual))
                    for k, v in t._asdict().items()})
    if args.partition != "none":
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    return row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(partition, world, args, out) -> list:
    """Start ``world`` rank processes of ``partition`` and return their
    rows; a rank that fails kills the others and raises with its log."""
    port = _free_port()
    cmd = [sys.executable, "-m", "raocp_tpu_torch.scripts.bench_scaling",
           "--worker", "--partition", partition, "--world", str(world),
           "--port", str(port), "--out", out, "--iters", str(args.iters),
           "--num-stages", str(args.num_stages),
           "--num-states", str(args.num_states), "--dtype", args.dtype,
           "--device", args.device] + (["--pin"] if args.pin else [])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(_ROOT), os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    rows = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=RANK_TIMEOUT)
            if p.returncode != 0:
                raise RuntimeError(f"a {partition} rank of {world} exited "
                                   f"with {p.returncode}:\n{stderr[-4000:]}")
            rows.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rows


def _rel_diff(out, a, b) -> float:
    """The largest distance between two saved results, leaf by leaf,
    relative to the leaf's largest entry in ``b``."""
    with np.load(os.path.join(out, a)) as got, \
            np.load(os.path.join(out, b)) as ref:
        worst = 0.0
        for k in ref.files:
            r = ref[k].astype(np.float64)
            g = got[k].astype(np.float64)[:r.shape[0]]
            scale = max(float(np.abs(r).max(initial=0.0)), 1e-30)
            worst = max(worst, float(np.abs(g - r).max(initial=0.0)) / scale)
    return worst


def run_scaling(ranks=(1, 2, 4), partitions=("subtree", "flat"),
                num_stages=8, num_states=50, iters=500, pin=False,
                dtype="float32", device="cuda"):
    """The rows of every (partition, ranks): one rank runs the
    partition-free baseline, more ranks each partition. Yields each row as
    it is made; raises where a count differs from the plan or, in
    float64, a result from the single device's."""
    args = argparse.Namespace(iters=iters, num_stages=num_stages,
                              num_states=num_states, pin=pin, dtype=dtype,
                              device=device)
    with tempfile.TemporaryDirectory() as out:
        base = None
        runs = [("none", 1)] + [(p, w) for w in ranks if w > 1
                                for p in partitions]
        for partition, world in runs:
            got = _run_world(partition, world, args, out)
            lead = got[0]
            mean_ips = sum(r["iters_per_s"] for r in got) / world
            if base is None:
                base = mean_ips
            plan = planned_collectives(partition, num_stages + 1,
                                       lead["iters"])
            row = dict(
                mode="multiprocess-gloo", partition=partition, ranks=world,
                pinned=pin, num_stages=num_stages, num_states=num_states,
                num_nodes=lead["num_nodes"], iters=lead["iters"],
                dtype=lead["dtype"], device=lead["device"],
                card=lead["card"], iters_per_s=mean_ips,
                ms_per_step=[r["ms_per_step"] for r in got],
                speedup=mean_ips / base, efficiency=mean_ips / base / world,
                all_reduces_per_step=lead["all_reduces"] / lead["iters"],
                exchanges_per_step=lead["exchanges"] / lead["iters"],
                planned=plan, all_reduces=lead["all_reduces"],
                exchanges=lead["exchanges"],
                **{k: [r[k] for r in got] for k in (
                    "all_reduce_bytes_per_step", "exchange_bytes_per_step",
                    "all_reduce_ms_per_step", "exchange_ms_per_step",
                    "wait_ms_per_step", "max_memory_allocated_mb")},
                max_rel_diff_vs_single=_rel_diff(out, f"{partition}{world}"
                                                 ".npz", "none1.npz"))
            yield row
            counts = [(r["all_reduces"], r["exchanges"]) for r in got]
            if any(c != (plan["all_reduces"], plan["exchanges"])
                   for c in counts):
                raise AssertionError(f"{partition} at {world} ranks: "
                                     f"collectives {counts}, planned {plan}")
            if dtype == "float64" and row["max_rel_diff_vs_single"] > F64_REL:
                raise AssertionError(
                    f"{partition} at {world} ranks: "
                    f"{row['max_rel_diff_vs_single']} from the single "
                    "device's result")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--partitions", default="subtree,flat")
    ap.add_argument("--num-stages", type=int, default=8)
    ap.add_argument("--num-states", type=int, default=50)
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--pin", action="store_true",
                    help="pin each CPU rank to one core of its own")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--dtype", default="float32",
                    help=argparse.SUPPRESS)     # a rank's, from its parent
    # one rank (the script starts itself so)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--partition")
    ap.add_argument("--world", type=int)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(run_rank(args)), flush=True)
        return
    for row in run_scaling(
            tuple(int(r) for r in args.ranks.split(",")),
            tuple(args.partitions.split(",")), args.num_stages,
            args.num_states, args.iters, args.pin, device=args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
