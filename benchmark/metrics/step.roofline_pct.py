"""Percent of the card's roofline at which a CP iteration runs: the least
time of one CP step by the benchmark's own count
(``benchmark/work.py``'s ``cp_step``) over the device's busy time an
iteration in the traced slice."""


def read(run):
    s = run["slice"]
    if s is None or not s["iterations"] or not s["summary"]["busy_s"]:
        return None
    per_iter = s["summary"]["busy_s"] / s["iterations"]
    return 100.0 * run["work"]["cp_step"] / per_iter
