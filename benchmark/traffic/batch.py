"""Traffic kind ``batch``: one caller who hands the solver ``lanes``
problems at once and, when the batch is solved, the next ``lanes``. The
problems are those of the ``solve`` kind (the family's frozen list of
initial states, each with a sign drawn from the seed); batch k holds
problems k lanes to (k + 1) lanes - 1, in order, and is one
``Solver.solve_batch`` call with the mix's options (plain CP, cold). Each
lane stops at its own tolerance; the batch ends with its last lane."""

import time

from benchmark import system
from benchmark.reference import problem as bp

# the mix's parameters that are the batch solve's options
OPTIONS = ("tol", "max_iters", "check_every", "unroll", "relax")


class Traffic:
    """Set-up on construction: the solver built inside a span, its step
    size, and one batch solve that stops at its first check, which
    captures the window's loop of ``lanes`` lanes."""

    def __init__(self, config: dict, params: dict, seed: int, device):
        self.config, self.params, self.device = config, params, device
        self.lanes = params["lanes"]
        if params["problems"] % self.lanes:
            raise ValueError("the mix's problems are not whole batches")
        self.options = {k: params[k] for k in OPTIONS if k in params}
        pl = bp.plant(config)
        self.x0s = bp.initial_states(config, seed, params["problems"],
                                     params["x0_scale"])
        self.spans = []
        before = system.counters()
        problem = system.build_problem(config, pl, pl.v)
        self.solver = system.make_solver(problem, config, device, self.spans)
        self.solver.solve_batch(self.x0s[-self.lanes:],
                                **{**self.options, "tol": 1e30})
        system.sync(device)
        self.setup_counts = system.delta(before, system.counters())

    def window(self, seconds: float) -> dict:
        """Batches one after another until the first that ends after
        ``seconds``; a record a lane."""
        before = system.counters()
        records, walls = [], []
        t0 = time.perf_counter()
        for first in range(0, len(self.x0s), self.lanes):
            x0s = self.x0s[first:first + self.lanes]
            tic = time.perf_counter()
            results = self.solver.solve_batch(x0s, **self.options)
            toc = time.perf_counter()
            walls.append(toc - tic)
            records.extend(system.result_record(res, x0)
                           for res, x0 in zip(results, x0s))
            if toc - t0 >= seconds:
                break
        else:
            raise RuntimeError("the mix ran out of problems before the "
                               "window closed")
        return dict(records=records, walls=walls, window_s=toc - t0,
                    lanes=self.lanes,
                    counts=system.delta(before, system.counters()))

    def slice(self, iterations: int, profile) -> dict:
        """``iterations`` batch steps of the window's loop from its first
        batch (no tolerance stops a lane), three times untraced (the first
        captures a loop of that length, the rest are timed) and once under
        ``profile``."""
        opts = {**self.options, "max_iters": iterations, "tol": 0.0}
        x0s = self.x0s[:self.lanes]
        self.solver.solve_batch(x0s, **opts)
        untraced = system.timed(lambda: self.solver.solve_batch(x0s, **opts),
                                self.device)
        results, summary = profile(lambda: self.solver.solve_batch(x0s,
                                                                   **opts))
        steps = max(res.num_iters for res in results)
        return dict(iterations=steps, t_evals=steps, summary=summary,
                    untraced_s=untraced)

    def answers(self, window: dict) -> list:
        """(answer, its initial state, its root mode) of each lane."""
        return [(r, r["x0"], None) for r in window["records"]]

    def release(self):
        del self.solver
