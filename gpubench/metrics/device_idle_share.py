"""The share of the traced window in which no operation ran on the card
(kernels, copies and sets, from the ``torch.profiler`` timeline), in %."""


def read(run, name):
    prof = run.profile
    if prof is None or not prof.device:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
