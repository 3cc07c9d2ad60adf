"""Role: the Hermitian shell binning of power volumes (the shared walk).

``csrc/shell_bins.cuh`` ``shell_walk_kernel<C, counts, Rows>``: K4 (two
channels on the folded quadrant), B4 (one channel folded), B11a (two
channels folded, with a count channel), B10 (unfolded half-spectrum) and
B6 (x-chunks or y-slabs of one). Each of the C float32 channels is read
once over the cells inside the last shell, C float64 sums a shell (and
the counts) are written once; 4 operations a cell and channel. A folded
launch bins the cell's whole folded quadrant. The trace does not tell
B10 (a whole half-spectrum) from B6 (a chunk at an offset the trace does
not give), so an unfolded launch's work is not counted.
"""

from harness.roofline import folded_inside, template_args

ROLE = "shell binning"
NAMES = (r"(?<![A-Za-z0-9_])shell_walk_kernel\b",)
COUNTERS = ("shell_bin_values_folded", "shell_bin_values_folded_1ch", "shell_bin_sums_unfolded",
            "shell_bin_values_rfft_chunk", "shell_bin_values_rfft_chunk_1ch",
            "shell_bin_sums_folded_onepass")


def work(kernel, ctx):
    args = template_args(kernel, "shell_walk_kernel")
    if len(args) < 3 or args[2].endswith("UnfoldedRows"):
        return None
    channels = int(args[0])
    counts = args[1] == "true"
    nx, ny, nz = ctx.shape
    nbins = ctx.nbins
    inside = folded_inside(nx, ny, nz, nbins)
    out = 8 * nbins * (channels + (1 if counts else 0))
    return 4 * channels * inside + out, 4 * channels * inside
