"""Launches of the over-relaxation kernel a CP step of the plain device
loop over the window (``solver.LOOP_COUNTS``' ``relax_launches`` over
``steps``): 1 where every step relaxes (``relax`` other than 1.0) through
the one hand-written kernel, 0 where no step relaxes; nothing from a
package that has no such count."""


def read(run):
    c = run["window"]["counts"]["loop"]
    if "relax_launches" not in c or not c.get("steps"):
        return None
    return c["relax_launches"] / c["steps"]
