"""Percent of the slice in which no device event (kernel, copy, set) ran,
as the slice runs untraced: 100 less the traced slice's busy time (the
union of its device intervals) over the wall time of the same slice run
untraced just before it (the shorter of two runs). The traced window is
not the divisor: the tracer holds the host at each graph launch (about a
microsecond a node), which idles the card in the traced run alone."""


def read(run):
    s = run["slice"]
    if s is None or not s["untraced_s"] or not s["summary"]["busy_s"]:
        return None
    return 100.0 * (1.0 - s["summary"]["busy_s"] / s["untraced_s"])
