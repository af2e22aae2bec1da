"""The card's kernel time a query, in microseconds: the window's kernels
alone, from the ``torch.profiler`` timeline, over the queries the window
answered.  Copies and sets are left out: a copy to pageable host memory
lasts as long as the host takes to drain it, so it swings with the host."""

#: device activities that are no kernel
NOT_KERNELS = r"^(?!Memcpy|Memset)"


def read(run, name):
    prof = run.profile
    if prof is None or not run.queries:
        return None
    seconds = prof.kernel_s(NOT_KERNELS)
    return 1e6 * seconds / sum(run.queries) if seconds > 0 else None
