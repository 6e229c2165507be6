"""Seconds that set-up spent building the cell's stacked problems inside
``Solver(...)`` (the span ``raocp.setup.build``, synchronised:
``build_seconds`` of ``solver.LOOP_COUNTS``)."""


def read(run):
    return run["setup"]["counts"]["loop"].get("build_seconds")
