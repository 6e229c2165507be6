"""Percent of the plain device loop's steps over the window that ran past
the stopping test (``solver.LOOP_COUNTS``' ``wasted_steps`` over
``steps``): the period enqueued ahead of the flag the host reads."""


def read(run):
    c = run["window"]["counts"]["loop"]
    return 100.0 * c["wasted_steps"] / c["steps"] if c["steps"] else None
