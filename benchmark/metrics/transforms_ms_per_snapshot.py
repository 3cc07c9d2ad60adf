"""Device time of the operations launched inside the port's fava.transforms
span (the square root of the density, its three products with the
velocities and the three real transforms), per snapshot, in ms; each
operation is found by its launch (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.stage_ms_per_snapshot(run, "fava.transforms")
