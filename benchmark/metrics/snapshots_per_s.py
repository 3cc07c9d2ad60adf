"""Snapshots whose outputs reached the host in the window, over the
window's seconds (host clock; the window ends with the last request)."""


def read(run):
    if run.trace is not None or not run.window_s:
        return None
    return run.snapshots / run.window_s
