"""Role: the regrid of AMR leaf blocks onto a uniform window.

K7 (``csrc/amr_kernels.cu`` ``regrid_kernel``): each output cell written
once and each source cell that some output cell takes read once, a
float32 value a field; no arithmetic to speak of. The trace and the
cell's shape do not give the source cells, so the work is not counted:
the cell that first launches K7 gives this role its count.
"""

ROLE = "regrid"
NAMES = (r"(?<![A-Za-z0-9_])regrid_kernel\b",)
COUNTERS = ("regrid_fields",)


def work(kernel, ctx):
    return None
