"""Percent of the window's replayed device loops that the card sat idle
between two periods of one call: the loops' gaps over their gaps and
periods, both on the card's clock as the package marks it in each replay
(``gap_device_seconds`` and ``period_device_seconds`` of
``solver.LOOP_COUNTS`` and ``accel.LOOP_COUNTS``, summed over both)."""


def read(run):
    c = run["window"]["counts"]
    gap = sum(c[p].get("gap_device_seconds", 0.0) for p in ("loop", "accel"))
    busy = sum(c[p].get("period_device_seconds", 0.0)
               for p in ("loop", "accel"))
    return 100.0 * gap / (gap + busy) if gap + busy else None
