"""Mean milliseconds a request of the program's own ``merge`` span (the
host merge of base and delta under (score desc, id asc))."""
from gpubench.spans import mean_span_ms


def read(run, name):
    return mean_span_ms(run, "merge")
