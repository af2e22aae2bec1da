"""Seconds from the process's start to the first timed request: imports,
kernel builds, data, the index, set-up's mutations and the warm-up; the
reference's own sizing of the bucket is left out."""


def read(run, name):
    return run.setup_s
