"""Launches of the dual-update kernel a CP step of the plain device loop
over the window (``solver.LOOP_COUNTS``' ``dual_launches`` over
``steps``): 1 where every step's dual update is the one hand-written
kernel; nothing from a package that has no such count."""


def read(run):
    c = run["window"]["counts"]["loop"]
    if "dual_launches" not in c or not c.get("steps"):
        return None
    return c["dual_launches"] / c["steps"]
