"""The 90th percentile (nearest rank) of every request's wall in the
window, from the call to its outputs on the host (host clock)."""

import math


def read(run):
    if run.trace is not None or not run.walls:
        return None
    walls = sorted(run.walls)
    return 1e3 * walls[math.ceil(0.9 * len(walls)) - 1]
