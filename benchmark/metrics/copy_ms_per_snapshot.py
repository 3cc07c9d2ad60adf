"""Device time of memcpy and memset operations in the traced window, per
snapshot, in ms."""


def read(run):
    if run.trace is None:
        return None
    us = sum(op.dur for op in run.trace.ops if op.cls == "copy")
    return us / 1e3 / run.snapshots if us > 0 else None
