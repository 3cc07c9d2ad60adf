"""Share of the traced window in which no kernel, copy or memset ran on
the device (the union of their intervals), in %."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us)
