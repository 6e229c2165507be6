"""Milliseconds a control step spends outside its solve (the plant step,
the warm-start hand-off, the solver's lookup): the window's wall time less
the solves' calls, over the steps, by the benchmark's clock."""


def read(run):
    w = run["window"]
    if "modes" not in w:
        return None
    return 1e3 * (w["window_s"] - sum(w["walls"])) / len(w["records"])
