"""Percent of the window's solves (the span ``raocp.solve``,
``solve_seconds`` of ``solver.LOOP_COUNTS``) spent outside their device
loops' drives (``drive_seconds`` of ``solver.LOOP_COUNTS`` and
``accel.LOOP_COUNTS``): each call's entry, chunk hand-offs and host
snapshots, final reads and result."""


def read(run):
    c = run["window"]["counts"]
    solve = c["loop"].get("solve_seconds", 0.0)
    if not solve:
        return None
    drive = sum(c[p].get("drive_seconds", 0.0) for p in ("loop", "accel"))
    return 100.0 * (1.0 - drive / solve)
