"""Mean milliseconds a request of the program's own ``delta`` span (the
delta segment's launch and its answer copied to the host)."""
from gpubench.spans import mean_span_ms


def read(run, name):
    return mean_span_ms(run, "delta")
