"""K1 against the torch stage path on the card (counterpart of the JAX
package's ``scripts/bench_pallas.py``, which times its Pallas kernel
against the XLA stage path).

    python -m raocp_tpu_torch.scripts.bench_pallas

The stage path (``prox.project_dynamics_stages``) is what
``prox.project_dynamics`` runs on every tree K1 does not take: a
partition's block, a ragged or mode-constant tree. On the trees both take,
this script times the two on the same stacked problem and inputs, in the
JAX script's four regimes from deep and narrow to wide and shallow, and on
BASELINE config 5's full tree as the closed loop builds it: nodes, each
path's µs an apply by the wall (CUDA events around 200 back-to-back
applies, each taking the previous one's x and u, best of 3) and on the
card (a ``torch.profiler`` trace of 20), the launches of each, K1's
counted launches beside its schedule's, the speedup (stage path over K1)
and the largest difference between the two outputs relative to the
output's largest entry.
Float32, ``offline="device"``. It needs a card.
"""

import argparse
import json

import numpy as np
import torch

from raocp_tpu_torch import models
from raocp_tpu_torch.ops import sweep
from raocp_tpu_torch.ops.prox import project_dynamics, project_dynamics_stages
from raocp_tpu_torch.scripts.bench_configs import CONFIG5, card
from raocp_tpu_torch.scripts.profile_step import is_k1, traced_events
from raocp_tpu_torch.scripts.roofline import chain, require_card, wall_us
from raocp_tpu_torch.solver import Solver, pin_full_precision

__all__ = ["CONFIGS", "stacked", "ab_row"]

# name -> random_network_problem's arguments, deep and narrow to wide and
# shallow (the JAX script's four), then config 5's per-step tree, built by
# network_mpc_controller (None)
CONFIGS = {
    "deep_binary_14st_8state": dict(num_states=8, num_inputs=3, num_modes=2,
                                    num_stages=14, stopping_time=14),
    "deep_tern_10st_16state": dict(num_states=16, num_inputs=6, num_modes=3,
                                   num_stages=10, stopping_time=10),
    "headline_8st_50state": dict(num_states=50, num_inputs=20, num_modes=3,
                                 num_stages=8, stopping_time=8),
    "wide_5st_96state": dict(num_states=96, num_inputs=32, num_modes=3,
                             num_stages=5, stopping_time=5),
    "config5_mpc_10st_100state": None,
}


def stacked(name: str, device="cuda"):
    """(stacked problem, x0) of ``CONFIGS[name]`` in float32."""
    kwargs = CONFIGS[name]
    if kwargs is None:
        controller, x0 = models.network_mpc_controller(
            **CONFIG5, dtype=torch.float32, offline="device", device=device)
        return controller.solver_for_mode(0)[0].stacked, x0
    spec, x0 = models.random_network_problem(**kwargs)
    return Solver(spec, dtype=torch.float32, offline="device",
                  device=device).stacked, x0


def _device(events, applies):
    """(µs, launches, K1 launches) an apply of a trace's device events."""
    return (sum(ev["dur"] for ev in events) / applies,
            len(events) / applies,
            sum(is_k1(ev["name"]) for ev in events) / applies)


def ab_row(name: str, sp, x0, applies: int = 200, traced: int = 20,
           seed: int = 0) -> dict:
    """The A/B of K1 and the stage path on ``sp`` (a card's problem that K1
    takes), from x and u of ``numpy`` seed ``seed`` normals."""
    if sp.device.type != "cuda" or not sweep.sweep_eligible(sp):
        raise RuntimeError(f"{name}: the A/B needs a card's problem that K1 "
                           "takes")
    rng = np.random.default_rng(seed)
    x, u, x0 = (torch.as_tensor(a, dtype=sp.dtype, device=sp.device)
                for a in (rng.standard_normal((sp.np_pad, sp.n)),
                          rng.standard_normal((sp.nl_pad, sp.m)), x0))
    before = sweep.LAUNCHES
    xs, us = project_dynamics_stages(sp, x, u, x0)
    stage_counted = sweep.LAUNCHES - before
    xk, uk = project_dynamics(sp, x, u, x0)
    k1_counted = sweep.LAUNCHES - before
    scale = max(float(xs.abs().max()), float(us.abs().max()))
    diff = max(float((xk - xs).abs().max()), float((uk - us).abs().max()))
    finite = bool(torch.isfinite(xk).all() and torch.isfinite(uk).all()
                  and torch.isfinite(xs).all() and torch.isfinite(us).all())
    stage = chain(lambda a, b: project_dynamics_stages(sp, a, b, x0), x, u)
    k1 = chain(lambda a, b: project_dynamics(sp, a, b, x0), x, u)
    row = dict(config=name, nodes=sp.num_nodes, n=sp.n, m=sp.m,
               stages=sp.num_stages, dtype=str(sp.dtype),
               card=card(sp.device), stage_us=wall_us(stage, applies),
               k1_us=wall_us(k1, applies))
    (row["stage_device_us"], row["stage_launches"],
     row["stage_k1_launches"]) = _device(traced_events(stage, traced),
                                         traced)
    (row["k1_device_us"], row["k1_device_launches"],
     row["k1_launches"]) = _device(traced_events(k1, traced), traced)
    row.update(
        k1_planned_launches=sweep.sweep_schedule(sp)["launch_count"],
        k1_counted_per_apply=k1_counted,
        stage_counted_per_apply=stage_counted,
        speedup=row["stage_us"] / row["k1_us"],
        device_speedup=row["stage_device_us"] / row["k1_device_us"],
        max_rel_diff=diff / scale, out_inf_norm=scale, finite=finite)
    return row


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    require_card("bench_pallas")
    pin_full_precision()
    for name in CONFIGS:
        sp, x0 = stacked(name)
        print(json.dumps(ab_row(name, sp, x0)), flush=True)


if __name__ == "__main__":
    main()
