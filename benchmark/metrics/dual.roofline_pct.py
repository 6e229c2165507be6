"""Percent of the card's roofline at which the dual-update kernel runs a
CP step's dual update: the least time of one update, of every lane of a
batch step, by the benchmark's own count (``benchmark/work.py``'s
``dual_update``) over the kernel's device time (its
``dual_update_kernel`` launches) an iteration in the traced slice. Nothing
where the slice ran no such kernel."""


def read(run):
    s = run["slice"]
    if s is None or not s["iterations"] or not s["summary"]["dual_s"]:
        return None
    per_step = s["summary"]["dual_s"] / s["iterations"]
    return 100.0 * run["work"]["dual_update"] / per_step
