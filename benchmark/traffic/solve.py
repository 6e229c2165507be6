"""Traffic kind ``solve``: one caller who hands the solver a problem and,
when it is solved, the next. The problems are the configuration's, each
from another initial state of the family's frozen list (its first
``problems`` draws, in order) with a sign drawn from the seed (the same
work whatever the sign), solved cold with the mix's options (plain CP, or
an accelerator by ``accel``)."""

import time

from benchmark import system
from benchmark.reference import problem as bp

# the mix's parameters that are the solve's options
OPTIONS = ("tol", "max_iters", "check_every", "unroll", "chunk_iters",
           "accel", "accel_memory", "relax")


class Traffic:
    """Set-up on construction: the solver built inside a span, its step
    size, and one solve that stops at its first check, which captures the
    window's loop."""

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.device = config, params, device
        self.options = {k: params[k] for k in OPTIONS if k in params}
        pl = bp.plant(config)
        self.x0s = bp.initial_states(config, seed, params["problems"],
                                     params["x0_scale"])
        self.spans = []
        before = system.counters()
        problem = system.build_problem(config, pl, pl.v)
        self.solver = system.make_solver(problem, config, device, self.spans)
        self.solver.solve(self.x0s[-1], **{**self.options, "tol": 1e30})
        system.sync(device)
        self.setup_counts = system.delta(before, system.counters())

    def window(self, seconds: float) -> dict:
        """Problems one after another until the first that ends after
        ``seconds``."""
        before = system.counters()
        records, walls = [], []
        t0 = time.perf_counter()
        for x0 in self.x0s:
            tic = time.perf_counter()
            res = self.solver.solve(x0, **self.options)
            toc = time.perf_counter()
            walls.append(toc - tic)
            records.append(system.result_record(res, x0))
            if toc - t0 >= seconds:
                break
        else:
            raise RuntimeError("the mix ran out of problems before the "
                               "window closed")
        return dict(records=records, walls=walls, window_s=toc - t0,
                    counts=system.delta(before, system.counters()))

    def slice(self, iterations: int, profile) -> dict:
        """``iterations`` of the window's loop from its first initial state
        (no tolerance stops them), three times untraced (the first
        captures a loop of that length, the rest are timed) and once under
        ``profile``."""
        opts = {**self.options, "max_iters": iterations, "tol": 0.0}
        opts.pop("chunk_iters", None)
        self.solver.solve(self.x0s[0], **opts)
        untraced = system.timed(lambda: self.solver.solve(self.x0s[0],
                                                          **opts),
                                self.device)
        before = system.counters()
        res, summary = profile(lambda: self.solver.solve(self.x0s[0],
                                                         **opts))
        counts = system.delta(before, system.counters())
        evals = counts["accel"]["t_evals"] if opts.get("accel") \
            else res.num_iters
        return dict(iterations=res.num_iters, t_evals=evals, summary=summary,
                    untraced_s=untraced)

    def answers(self, window: dict) -> list:
        """(answer, its initial state, its root mode) of each problem."""
        return [(r, r["x0"], None) for r in window["records"]]

    def release(self):
        del self.solver
