"""Device events (kernels, copies, sets) an iteration in the traced
slice."""


def read(run):
    s = run["slice"]
    if s is None or not s["iterations"]:
        return None
    return s["summary"]["device_events"] / s["iterations"]
