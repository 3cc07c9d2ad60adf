"""Role: the quadrant fold of the total and longitudinal power.

K3 (``csrc/flagship_kernels.cu`` ``fold_pair_kernel``): two float32
(nx, ny, nz/2+1) power volumes read once, two (nx/2+1, ny/2+1, nz/2+1)
folds written once; 2 additions a cell read.
"""

ROLE = "fold"
NAMES = (r"(?<![A-Za-z0-9_])fold_pair_kernel\b",)
COUNTERS = ("fold_quadrants_pair",)


def work(kernel, ctx):
    nx, ny, nz = ctx.shape
    cells = nx * ny * (nz // 2 + 1)
    folded = (nx // 2 + 1) * (ny // 2 + 1) * (nz // 2 + 1)
    return 8 * cells + 8 * folded, 2 * cells
