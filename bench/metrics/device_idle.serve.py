"""% of the traced window in which no operation ran on the card."""
from bench.trace import idle_share


def read(run):
    return idle_share(run)
