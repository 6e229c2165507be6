#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the system's place, computed in the precision below the
configuration's (float32 with TF32 products for float32 with TF32 off),
driven with the cell's own problems and options, and held to the cell's own
numbers. It has to come out as not correct. Benchmark runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--problems 2]

For a ``solve`` or ``batch`` cell it solves ``--problems`` initial states
of each seed by plain CP, one at a time, the k-th seed the k-th
``--problems`` of the mix's list, so that the seeds meet distinct problems
(an accelerated or batched cell's control is plain CP too: the answer
asked for is the same); for an ``mpc`` cell it runs that many closed-loop
steps from the seed's first state and mode, warm-started, the later modes
drawn as the controller draws them. One JSON line a seed: the largest of
each number and its limit.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench  # noqa: E402
from benchmark.reference import problem as bp  # noqa: E402
from benchmark.reference.cp import Reference  # noqa: E402
from benchmark.reference.judge import Judge, episode_states  # noqa: E402


def lower_precision(config: dict):
    """The dtype of the control, with TF32 products switched on where the
    configuration states float32 with TF32 off."""
    if config["dtype"] == "float64":
        return torch.float32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return torch.float32


def _answer(z, e, iters, xi, x0) -> dict:
    host = lambda t: {k: v.double().cpu().numpy() for k, v in t.items()}
    return dict(primal=host(z), dual=host(e), num_iters=iters,
                xi=float(max(xi)), x0=np.asarray(x0, dtype=np.float64))


def control_answers(spec: dict, seed: int, problems: int, device,
                    dtype, first: int = 0) -> list:
    """(answer, initial state, root mode) of the control's problems: of a
    ``solve`` or ``batch`` cell, the mix's problems ``first`` to ``first +
    problems``."""
    config, params = spec["config"], spec["mix"]["params"]
    kind = spec["mix"]["kind"]
    pl = bp.plant(config)
    opts = dict(tol=params["tol"], max_iters=params["max_iters"],
                check_every=params["check_every"])
    if kind in ("solve", "batch"):
        ref = Reference(config, pl, bp.config_tree(config), device, dtype)
        x0s = bp.initial_states(config, seed, params["problems"],
                                params["x0_scale"])
        out = []
        for x0 in x0s[first:first + problems]:
            z, e, k, xi = ref.solve(x0, **opts)
            out.append((_answer(z, e, k, xi, x0), x0, None))
        return out
    (x,) = bp.initial_states(config, seed, 1, params["x0_scale"])
    x_first = x.copy()
    # the controller's draws: the first mode, then each step's next mode
    rng = np.random.default_rng(params["mode_seed"])
    w = int(rng.integers(config["num_modes"]))
    relax = 1.8 if params.get("relax") == "auto" else params.get("relax", 1.0)
    refs, modes, answers, prev = {}, [], [], None
    for _ in range(problems):
        if w not in refs:
            refs[w] = Reference(config, pl, bp.markov_tree(
                pl.P, pl.P[w], config["num_stages"],
                config["stopping_time"]), device, dtype)
        z, e, k, xi = refs[w].solve(x, relax=relax, warm_start=prev, **opts)
        answers.append(_answer(z, e, k, xi, x))
        modes.append(w)
        prev = (z, e)
        u = z["u"][0].double().cpu().numpy()
        w = int(rng.choice(config["num_modes"], p=pl.P[w]))
        x = pl.A[w] @ x + pl.B[w] @ u
    xs = episode_states(config, x_first, modes, answers)
    return list(zip(answers, xs, modes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--problems", type=int, default=2)
    args = ap.parse_args(argv)
    spec = bench.cell(args.workload)
    device = "cuda"
    params = spec["mix"]["params"]
    limits = spec["workload"]["judge"]
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        dtype = lower_precision(spec["config"])
        answers = control_answers(spec, seed, args.problems, device, dtype,
                                  first=k * args.problems)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        judge = Judge(spec["config"], params["tol"], device)
        got = [judge.numbers(a, x0, mode) for a, x0, mode in answers]
        worst = {k: max(g[k] for g in got) for k in got[0]}
        print(json.dumps(dict(
            workload=args.workload, seed=seed,
            control=("tf32" if spec["config"]["dtype"] == "float32"
                     else "float32"),
            iterations=[a["num_iters"] for a, _, _ in answers],
            reported_xi=[a["xi"] for a, _, _ in answers],
            numbers={k: dict(value=v, limit=limits.get(k))
                     for k, v in worst.items()},
            correct=all(worst[k] <= limits[k] for k in limits))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
