"""Seconds that set-up spent in the power iterations that set the cell's
step sizes (the span ``raocp.setup.power``: ``power_seconds`` of
``solver.LOOP_COUNTS``)."""


def read(run):
    return run["setup"]["counts"]["loop"].get("power_seconds")
