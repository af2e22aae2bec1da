"""The 95th percentile of every request's time in the traced window, from
its send to the returned answer (host arrays, so the device work is done),
in ms: the tail of a cell whose card sits idle most of the window."""
import numpy as np


def read(run, name):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
