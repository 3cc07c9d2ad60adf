"""Device time of the operations launched inside the port's fava.profiles
span (the two row-moment kernels and the assembly of the Reynolds-stress
and Favre profiles), per snapshot, in ms; each operation is found by its
launch (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.stage_ms_per_snapshot(run, "fava.profiles")
