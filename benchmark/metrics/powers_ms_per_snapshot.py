"""Device time of the operations launched inside the port's fava.powers
span (the total and longitudinal power volumes, their Nyquist split and
their contiguous copies), per snapshot, in ms; each operation is found
by its launch (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.stage_ms_per_snapshot(run, "fava.powers")
