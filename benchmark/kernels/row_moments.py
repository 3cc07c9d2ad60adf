"""Role: the raw row moments of a uniform volume profiled along x.

K1 (``csrc/flagship_kernels.cu`` ``row_moments_kernel``): four float32
fields read once, 13 float64 sums a row written once; 22 operations a
cell (the products and the sums).
"""

ROLE = "row moments"
NAMES = (r"(?<![A-Za-z0-9_])row_moments_kernel\b",)
COUNTERS = ("row_moments",)
NMOM = 13


def work(kernel, ctx):
    nx, ny, nz = ctx.shape
    n = nx * ny * nz
    return 16 * n + 8 * NMOM * nx, 22 * n
