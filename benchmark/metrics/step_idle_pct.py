"""Device idle inside the step: the idle gaps of the traced window that
fall, on the host's clock, inside one of the port's four stage spans
(fava.transforms, fava.powers, fava.binning, fava.profiles), as a share
of the window, in %. A gap is placed on the host's clock by the launch
of the operation that ends it (harness/spans.py), since the device's
timestamps drift from the host's. device_idle_pct less this is the idle
between the stages, snapshots and requests."""

from harness import spans


def read(run):
    found = spans.read(run)
    if found is None or run.trace.window_us <= 0 or not run.trace.ops:
        return None
    idle = sum(b - a for a, b in run.trace.gaps() if found.in_step(a, b))
    return 100.0 * idle / run.trace.window_us
