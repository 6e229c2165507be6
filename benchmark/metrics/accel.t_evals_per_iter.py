"""T evaluations (CP steps) an accelerated iteration over the window, both
counted on the device (``accel.LOOP_COUNTS``' ``t_evals`` and
``iterations``)."""


def read(run):
    c = run["window"]["counts"]["accel"]
    return c["t_evals"] / c["iterations"] if c["iterations"] else None
