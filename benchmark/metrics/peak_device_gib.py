"""torch.cuda.max_memory_allocated() over the window, reset at its start
(the resident inputs included), in GiB."""


def read(run):
    if run.trace is not None or run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
