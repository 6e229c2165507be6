#!/usr/bin/env python3
"""The benchmark of raocp_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. A cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything else is found by name under ``benchmark/``:

* ``workloads/<cell>.json``: the configuration and the traffic mix, the
  limits of the numbers that decide ``correct`` (``judge``) and the length
  of the traced slice (``slice_iterations``);
* ``traffic/<mix>.json``: the mix's kind and parameters; ``traffic/<kind>.py``
  drives the system under test with them;
* ``configs/<config>.json``: the problem's sizes and what was cut;
* ``metrics/<metric>.py``: a reader for each per-layer metric.

A run builds and warms up the cell's solvers (set-up), measures a window of
``--seconds`` (whole problems: it ends with the first problem that ends
after ``--seconds``), with ``--trace 1`` profiles a bounded slice of the
window's loop, frees the system's state, and holds every answer of the
window against the plain reference (``benchmark/reference/``). It prints
one JSON line last: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. It exits non-zero, printing no result,
without a card (or with fewer than the cell asks for), or if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``raocp_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "raocp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``raocp_tpu_torch`` is not ``raocp_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def load_module(path: Path):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    """The cell ``name``: its entry, workload, mix, configuration and the
    end-to-end and per-layer metrics it reports, from ``BENCHMARK.json``
    and the files it names."""
    bench = load_json(ROOT / "BENCHMARK.json")
    (entry,) = [w for w in bench["workloads"] if w["name"] == name]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                      entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another config or "
                         "traffic than BENCHMARK.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return dict(name=name, entry=entry, workload=workload, mix=mix,
                config=config,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


CARD = ("power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
        "temperature.gpu")


def card_fields(device) -> dict:
    """What the result says of the card: its name and count, and as
    ``nvidia-smi`` reads them once the window has closed, its power limit
    and draw, its SM clock and maximum, and its temperature."""
    import torch

    index = torch.device(device).index or 0
    read = subprocess.run(
        ["nvidia-smi", f"--id={index}", f"--query-gpu={','.join(CARD)}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    values = [v.strip() for v in read.stdout.split(",")]
    return dict(platform="gpu", kind=torch.cuda.get_device_name(index),
                count=1, **dict(zip((c.replace(".", "_") for c in CARD),
                                    values if len(values) == len(CARD)
                                    else [None] * len(CARD))))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """One run of the cell ``spec`` (:func:`cell`): set-up, the window,
    with ``trace`` the traced slice, then the reference's numbers of every
    answer. Returns what the metrics' readers read."""
    import torch

    from benchmark import trace as tr
    from benchmark import work
    from benchmark.reference.judge import Judge

    cuda = torch.device(device).type == "cuda"
    config, mix, workload = spec["config"], spec["mix"], spec["workload"]
    params = mix["params"]
    kind = load_module(HERE / "traffic" / f"{mix['kind']}.py")
    traffic = kind.Traffic(config, params, seed, device)
    setup = dict(seconds=time.perf_counter() - T0, spans=traffic.spans,
                 counts=traffic.setup_counts)
    window = traffic.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    piece = None
    if trace:
        piece = traffic.slice(workload["slice_iterations"], tr.profile_call)
    answers = traffic.answers(window)
    traffic.release()
    del traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judge = Judge(config, params["tol"], device)
    limits = workload["judge"]
    worst = {k: 0.0 for k in limits}
    failed = 0
    for answer, x0, mode in answers:
        got = judge.numbers(answer, x0, mode)
        failed += any(got[k] > limits[k] for k in limits)
        worst = {k: max(worst[k], got[k]) for k in limits}
    # the least times of one step's work, of every lane of a batch step
    lanes = params.get("lanes", 1)
    least = {part: lanes * work.least_time(getattr(work, part)(config),
                                           config)
             for part in ("cp_step", "project_dynamics", "dual_update")}
    return dict(config=config, setup=setup, window=window, slice=piece,
                peak=peak, failed=failed, worst=worst, limits=limits,
                work=least)


def end_to_end(run: dict) -> dict:
    """The end-to-end metrics of a run, by name."""
    w = run["window"]
    return dict(
        solve_s=w["window_s"] / len(w["records"]),
        cp_iter_per_s=sum(r["num_iters"] for r in w["records"])
        / w["window_s"],
        peak_mem_gib=run["peak"] / 2 ** 30,
        setup_s=run["setup"]["seconds"])


def result(spec: dict, run: dict, trace: bool, device_fields: dict) -> dict:
    """The result line: with ``trace`` the cell's per-layer metrics (each
    from its reader, left out where the reader finds nothing), else its
    end-to-end metrics; the numbers compared beside their limits last."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = end_to_end(run)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    device = dict(device_fields, memory_peak_bytes=run["peak"])
    out = dict(correct=run["failed"] == 0 and bool(run["window"]["records"]),
               attempted=len(run["window"]["records"]), failed=run["failed"],
               metrics=metrics, device=device)
    if trace:
        s = run["slice"]["summary"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = dict(device_ops=s["device_ops"],
                                idle_gaps=s["idle_gaps"])
    out["checks"] = {k: dict(value=run["worst"][k], limit=run["limits"][k])
                     for k in run["limits"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell(args.workload)

    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    card = card_fields("cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out = result(spec, run, bool(args.trace), card)
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
