"""Synchronisations the host makes in the traced window, per snapshot: the
CUDA calls that block it until the card has drained (harness/spans.py
SYNC_CALLS), the harness's copies of the outputs included. The port's
fava.* spans only name the site of each (spans.Spans.syncs)."""

from harness import spans


def read(run):
    found = spans.read(run)
    return None if found is None else sum(found.syncs.values()) / run.snapshots
