"""Host seconds spent launching the window's graph replays over the card's
seconds running them: ``launch_seconds`` (the span around each replay)
over ``period_device_seconds`` (the replays' marks on the card's clock),
each summed over ``solver.LOOP_COUNTS`` and ``accel.LOOP_COUNTS``. Near 1
or above, the host launches a period no faster than the card runs one."""


def read(run):
    c = run["window"]["counts"]
    launch = sum(c[p].get("launch_seconds", 0.0) for p in ("loop", "accel"))
    busy = sum(c[p].get("period_device_seconds", 0.0)
               for p in ("loop", "accel"))
    return launch / busy if busy else None
