"""Traffic kind ``mpc``: one closed-loop risk-averse MPC episode, a control
step after another, each one solve warm-started from the last (the
package's ``RiskAverseMPC.run``). The episode starts from the
configuration's own initial state with a sign drawn from the seed; the
controller draws its first mode and the plant's later modes from the mix's
``mode_seed``. The problem is symmetric under x -> -x, so the episode's
work does not depend on the sign. Every root mode's solver is built in
set-up."""

import time

import numpy as np

import raocp_tpu_torch as rt
from benchmark import system
from benchmark.reference import problem as bp

OPTIONS = ("tol", "max_iters", "check_every", "unroll", "chunk_iters",
           "relax")


def first_mode(config: dict, params: dict) -> int:
    """The episode's first mode, as the controller draws it from
    ``mode_seed``."""
    rng = np.random.default_rng(params["mode_seed"])
    return int(rng.integers(config["num_modes"]))


class _Closed(Exception):
    """The window closed: the next control step's solve does not start."""


class Traffic:
    def __init__(self, config: dict, params: dict, seed: int, device):
        import torch

        self.config, self.params, self.device = config, params, device
        self.options = {k: params[k] for k in OPTIONS if k in params}
        pl = bp.plant(config)
        (self.x0,) = bp.initial_states(config, seed, 1, params["x0_scale"])
        self.mode0 = first_mode(config, params)
        self.spans = []
        before = system.counters()

        def factory(v):
            return system.build_problem(config, pl, v)

        self.controller = rt.RiskAverseMPC(
            factory, pl.P, dtype=getattr(torch, config["dtype"]),
            offline=config["offline"], device=device)
        self.solvers = {}
        for w in range(config["num_modes"]):
            system.sync(device)
            tic = time.perf_counter()
            solver = self.controller.solver_for_mode(w)[0]
            solver.operator_norm_sq()
            system.sync(device)
            self.spans.append(time.perf_counter() - tic)
            solver.solve(self.x0, **{**self.options, "tol": 1e30})
            self.solvers[w] = solver
        system.sync(device)
        self.setup_counts = system.delta(before, system.counters())

    def window(self, seconds: float) -> dict:
        """Control steps until the first whose solve ends after
        ``seconds``: the next step's solve is not started."""
        calls = []
        t0 = time.perf_counter()

        def wrap(mode, solve):
            def timed(x, **kw):
                if time.perf_counter() - t0 >= seconds and calls:
                    raise _Closed
                tic = time.perf_counter()
                res = solve(x, **kw)
                calls.append((mode, system.result_record(res, x),
                              time.perf_counter() - tic))
                return res
            return timed

        before = system.counters()
        for w, solver in self.solvers.items():
            solver.solve = wrap(w, solver.solve)
        try:
            self.controller.run(self.x0, self.params["max_steps"],
                                seed=self.params["mode_seed"],
                                **self.options)
        except _Closed:
            pass
        else:
            raise RuntimeError("the episode ended before the window closed")
        finally:
            t1 = time.perf_counter()
            for solver in self.solvers.values():
                del solver.solve
        return dict(records=[c[1] for c in calls], walls=[c[2] for c in calls],
                    modes=[c[0] for c in calls], window_s=t1 - t0,
                    counts=system.delta(before, system.counters()))

    def slice(self, iterations: int, profile) -> dict:
        """``iterations`` of the loop of the first mode's solver from the
        episode's first state (no tolerance stops them), three times
        untraced (the first captures, the rest are timed) and once under
        ``profile``."""
        solver = self.solvers[self.mode0]
        opts = {**self.options, "max_iters": iterations, "tol": 0.0}
        opts.pop("chunk_iters", None)
        solver.solve(self.x0, **opts)
        untraced = system.timed(lambda: solver.solve(self.x0, **opts),
                                self.device)
        res, summary = profile(lambda: solver.solve(self.x0, **opts))
        return dict(iterations=res.num_iters, t_evals=res.num_iters,
                    summary=summary, untraced_s=untraced)

    def answers(self, window: dict) -> list:
        """(answer, its initial state as the reference works it out, its
        root mode) of each control step."""
        from benchmark.reference.judge import episode_states

        xs = episode_states(self.config, self.x0, window["modes"],
                            window["records"])
        return list(zip(window["records"], xs, window["modes"]))

    def release(self):
        del self.solvers, self.controller
