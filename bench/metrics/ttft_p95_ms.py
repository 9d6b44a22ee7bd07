"""The 95th percentile (nearest rank) over every request of the window of
the time from its batch's submission to its token on the host."""
import math


def read(run):
    ttft = sorted(t for it in run.items for t in [it["ttft_s"]] *
                  it["requests"])
    if not ttft:
        return None
    return 1e3 * ttft[math.ceil(0.95 * len(ttft)) - 1]
