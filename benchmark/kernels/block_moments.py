"""Role: the raw row moments of a stack of AMR leaf blocks (or of slabs
of a streamed volume) profiled along x.

K5 (``csrc/amr_kernels.cu`` ``block_row_moments_kernel``): four float32
fields read once, 7 float64 sums a row written once; 10 operations a
cell. The trace and the cell's shape do not give the cells and rows of
a launch, so the work is not counted: the cell that first launches K5
gives this role its count.
"""

ROLE = "block moments"
NAMES = (r"(?<![A-Za-z0-9_])block_row_moments_kernel\b",)
COUNTERS = ("block_row_moments",)


def work(kernel, ctx):
    return None
