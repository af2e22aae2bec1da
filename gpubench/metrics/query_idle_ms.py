"""Device-idle milliseconds a request that fell inside the program's
``repro_torch.query`` ranges: the card's wait that program work can win
back.  The rest of the window's idle time is the caller's own time between
requests (the note gives the share inside)."""
from gpubench.ranges import idle_ms


def read(run, name):
    return idle_ms(run, "query")
