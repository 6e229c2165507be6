"""Percent of the window's lane-steps that ran on lanes that had already
stopped: 100 (1 - the lanes' own iterations, summed, over the lanes times
the batch steps that the plain device loop ran up to its stop), the batch
steps being ``steps`` less ``wasted_steps`` of ``solver.LOOP_COUNTS``.
Nothing outside a batch cell, or at 0 steps."""


def read(run):
    w = run["window"]
    if "lanes" not in w:
        return None
    c = w["counts"]["loop"]
    lane_steps = w["lanes"] * (c["steps"] - c["wasted_steps"])
    if not lane_steps:
        return None
    own = sum(r["num_iters"] for r in w["records"])
    return 100.0 * (1.0 - own / lane_steps)
