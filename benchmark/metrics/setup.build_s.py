"""Seconds in the construction of the cell's solvers, each with its step
size (the offline factorisation, the upload, the power iteration): the
benchmark's span around each, synchronised, summed."""


def read(run):
    return sum(run["setup"]["spans"])
