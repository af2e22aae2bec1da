"""Kernel launch calls of the CUDA runtime or driver that start inside the
program's ``repro_torch.query`` ranges, over the window's requests (the
note sets them beside the window's launch calls and kernel activities)."""
from gpubench.ranges import launches_per_request


def read(run, name):
    return launches_per_request(run, "query")
