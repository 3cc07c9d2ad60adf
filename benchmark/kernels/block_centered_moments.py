"""Role: the centered second moments of a stack of AMR leaf blocks (or
of slabs of a streamed volume) about their row means.

K6 (``csrc/amr_kernels.cu`` ``block_centered_row_moments_kernel``): four
float32 fields and 3 float64 means a row read once, 9 float64 sums a row
written once; 21 operations a cell. The trace and the cell's shape do
not give the cells and rows of a launch, so the work is not counted: the
cell that first launches K6 gives this role its count.
"""

ROLE = "block centered moments"
NAMES = (r"(?<![A-Za-z0-9_])block_centered_row_moments_kernel\b",)
COUNTERS = ("block_centered_row_moments",)


def work(kernel, ctx):
    return None
