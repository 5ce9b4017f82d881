"""device_idle.explore: share of the traced window with nothing running
on the card, in %."""
from bench.devtrace.readers import idle_share


def read(t):
    return idle_share(t)
