"""Host milliseconds a request inside the program's ``repro_torch.fetch``
ranges, base and delta together: the host's wait for the card and for the
answers' copies to pageable host memory."""
from gpubench.ranges import stage_ms


def read(run, name):
    return stage_ms(run, "fetch")
