"""The card's time a query, in microseconds: the seconds of the window in
which an operation ran on the card (kernels, copies and sets, from the
``torch.profiler`` timeline), over the queries the window answered."""


def read(run, name):
    prof = run.profile
    if prof is None or not prof.device or not run.queries:
        return None
    return 1e6 * prof.busy_s / sum(run.queries)
