"""The port's hand-written kernels in the traced window against their
roofline: the sum of their least times (by role, ``benchmark/kernels/``)
over the sum of their traced times, in %. A kernel whose role gives no
work adds its time and no least time."""

from harness.roofline import kernel_table


def read(run):
    if run.trace is None:
        return None
    rows = kernel_table([op for op in run.trace.ops if op.cls == "own"], run.roles, run.ctx)
    traced = sum(r.traced_us for r in rows)
    bound = sum(r.launches * r.bound_us for r in rows if r.bound_us is not None)
    if traced <= 0 or bound <= 0:
        return None
    return 100.0 * bound / traced
