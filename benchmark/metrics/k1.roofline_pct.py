"""Percent of the card's roofline at which K1 runs a dynamics projection:
the least time of one projection by the benchmark's own count
(``benchmark/work.py``'s ``project_dynamics``) over K1's device time (its
``stage_kernel`` and ``apex_kernel`` launches) a T evaluation in the
traced slice."""


def read(run):
    s = run["slice"]
    if s is None or not s["t_evals"] or not s["summary"]["k1_s"]:
        return None
    per_apply = s["summary"]["k1_s"] / s["t_evals"]
    return 100.0 * run["work"]["project_dynamics"] / per_apply
