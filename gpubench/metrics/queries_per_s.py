"""Queries answered in the window over the window's wall time (host clock)."""


def read(run, name):
    return sum(run.queries) / (run.t1 - run.t0)
