"""Seconds the device loops spent capturing their CUDA graphs in set-up,
as the package counts them (``capture_seconds`` of ``solver.LOOP_COUNTS``
and ``accel.LOOP_COUNTS``)."""


def read(run):
    c = run["setup"]["counts"]
    total = c["loop"]["capture_seconds"] + c["accel"]["capture_seconds"]
    return total if c["loop"]["captures"] + c["accel"]["captures"] else None
