"""Host milliseconds a request inside the program's ``repro_torch.assemble``
ranges: the facade's work on answers already on the host (the int64
widening, the id lookup, the result).  Notes every stage's milliseconds a
request beside it."""
from gpubench.ranges import stage_ms, stage_ms_by_name


def read(run, name):
    value = stage_ms(run, "assemble")
    if value is not None:
        run.notes["stages"] = "host ms a request: " + ", ".join(
            f"{s} {ms:.4f}" for s, ms in stage_ms_by_name(run).items())
    return value
