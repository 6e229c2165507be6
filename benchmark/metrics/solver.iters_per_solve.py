"""Iterations a solve of the window (``SolverResult.num_iters``), the mean:
plain CP steps, or an accelerator's outer iterations."""


def read(run):
    recs = run["window"]["records"]
    return sum(r["num_iters"] for r in recs) / len(recs)
