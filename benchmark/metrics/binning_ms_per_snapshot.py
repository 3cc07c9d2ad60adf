"""Device time of the operations launched inside the port's fava.binning
span (the quadrant fold and the folded shell binning, or the unfolded
binning; the static shell counts; the transverse split), per snapshot,
in ms; each operation is found by its launch (harness/spans.py)."""

from harness import spans


def read(run):
    return spans.stage_ms_per_snapshot(run, "fava.binning")
