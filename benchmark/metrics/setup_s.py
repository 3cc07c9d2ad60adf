"""Seconds from the start of the process to the first timed request:
imports, the kernels' build or load, the inputs, the warm-up requests."""


def read(run):
    return run.setup_s
