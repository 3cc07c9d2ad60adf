"""Device time of PyTorch's own kernels (the eager elementwise and
reduction ops) in the traced window, per snapshot, in ms."""


def read(run):
    if run.trace is None:
        return None
    us = sum(op.dur for op in run.trace.ops if op.cls == "torch")
    return us / 1e3 / run.snapshots if us > 0 else None
