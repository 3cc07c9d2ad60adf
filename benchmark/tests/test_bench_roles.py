"""The kernel roles: found by name, their work against hand counts."""

import math

import pytest

from fava_tpu_torch.ops import cuda_kernels as ck
from harness import roofline, spec

ROLES = {r.ROLE: r for r in spec.kernel_roles()}
SHAPE = (512, 512, 512)
CTX = roofline.Ctx(SHAPE)


def test_every_role_is_found():
    assert set(ROLES) == {
        "row moments", "centered moments", "fold", "shell binning", "fused powers and binning",
        "zy FFT", "zy FFT tables", "regrid", "pdf2d", "block moments", "block centered moments"}
    for role in ROLES.values():
        assert role.NAMES and callable(role.work)
        assert set(role.COUNTERS) <= set(ck.KERNELS), role.ROLE


def test_every_counter_has_a_role():
    counted = {c for r in ROLES.values() for c in r.COUNTERS}
    assert counted == set(ck.KERNELS)


@pytest.mark.parametrize("name,role", [
    ("void row_moments_kernel(float const*, float const*, float const*, float const*, double*, long long, long long)", "row moments"),
    ("centered_row_moments_kernel(float const*, float const*, float const*, float const*, double const*, double*, long long, long long)", "centered moments"),
    ("block_row_moments_kernel(float const*, float const*, float const*, float const*, double*, long long, long long, int)", "block moments"),
    ("block_centered_row_moments_kernel(float const*, ...)", "block centered moments"),
    ("fold_pair_kernel(float const*, float const*, float*, float*, int, int, int, int, int)", "fold"),
    ("void shell_walk_kernel<2, false, (anonymous namespace)::FoldedRows>(float const*, float const*, double*, (anonymous namespace)::FoldedRows, int, int)", "shell binning"),
    ("void powers_fold_bin_kernel<true>(Stack<true>, double*, int, int, int, int, int, int)", "fused powers and binning"),
    ("void zy_fft_kernel<0>(float const*, float*, float*, float4 const*, ZyFftPlan, int)", "zy FFT"),
    ("zy_rfft_kernel(float const*, float*, float*, int, int, int)", "zy FFT"),
    ("void zy_fft_tables_kernel<1>(float2*, ZyFftPlan)", "zy FFT tables"),
    ("void regrid_kernel<int>(RegridFields, int, int const*, long const*, int const*, int, int)", "regrid"),
    ("void pdf2d_kernel<true, false>(float const*, float const*, float const*, float const*, double*)", "pdf2d"),
])
def test_roles_match_names(name, role):
    assert roofline.role_of(name, list(ROLES.values())).ROLE == role


def _folded_inside_port(shape, nbins):
    nx, ny, nz = shape
    shells = ck._folded_shells((nx // 2 + 1, ny // 2 + 1, nz // 2 + 1), nbins, ny, "cpu")
    return int((shells < nbins).sum())


def _unfolded_inside_port(shape, nbins):
    nx, ny, nz = shape
    shells = ck._unfolded_shells((nx, ny, nz // 2 + 1), nbins, nz, "cpu")[0]
    return int((shells < nbins).sum())


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 32, 32), (64, 48, 40), (31, 33, 30), (128, 128, 128)])
def test_inside_counts_match_the_ports_shells(shape):
    nbins = max(shape) // 2 - 1
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:  # the fold takes even x and y extents
        assert roofline.folded_inside(*shape, nbins) == _folded_inside_port(shape, nbins)
    assert roofline.unfolded_inside(*shape, nbins) == _unfolded_inside_port(shape, nbins)


def test_k1_to_k4_hand_counts_at_512():
    n = 512**3
    assert ROLES["row moments"].work("row_moments_kernel", CTX) == (16 * n + 8 * 13 * 512, 22 * n)
    assert ROLES["centered moments"].work("centered_row_moments_kernel", CTX) == (
        16 * n + 8 * 12 * 512, 21 * n)
    cells, folded = 512 * 512 * 257, 257 * 257 * 257
    assert ROLES["fold"].work("fold_pair_kernel", CTX) == (8 * cells + 8 * folded, 2 * cells)
    inside = _folded_inside_port(SHAPE, 255)
    k4 = "void shell_walk_kernel<2, false, (anonymous namespace)::FoldedRows>(...)"
    assert ROLES["shell binning"].work(k4, CTX) == (8 * inside + 16 * 255, 8 * inside)


@pytest.mark.parametrize("role,kernel,bound_ms", [
    # chip_smoke.py's bound column (PERF.md's kernel table) at 512^3
    ("row moments", "row_moments_kernel", 0.6411),
    ("centered moments", "centered_row_moments_kernel", 0.6411),
    ("fold", "fold_pair_kernel", 0.2014),
    ("shell binning", "shell_walk_kernel<2, false, FoldedRows>", 0.02080),
    ("shell binning", "shell_walk_kernel<1, false, FoldedRows>", 0.01040),
    ("fused powers and binning", "powers_fold_bin_kernel<true>", 0.2481),
    ("zy FFT", "zy_fft_kernel<0>", 0.3211),
])
def test_bounds_match_the_kernel_table(role, kernel, bound_ms):
    got = 1e3 * roofline.least_seconds(*ROLES[role].work(kernel, CTX))
    assert math.isclose(got, bound_ms, rel_tol=6e-4), got


def test_roles_without_shapes_count_nothing():
    """Roles whose work the trace and the cell's shape do not give."""
    assert ROLES["regrid"].work("regrid_kernel", CTX) is None
    assert ROLES["block moments"].work("block_row_moments_kernel", CTX) is None
    assert ROLES["block centered moments"].work("block_centered_row_moments_kernel", CTX) is None
    assert ROLES["shell binning"].work("shell_walk_kernel<2, false, UnfoldedRows>", CTX) is None
    assert ROLES["shell binning"].work("shell_walk_kernel<1, false, UnfoldedRows>", CTX) is None


def test_pdf2d_weighted_from_template():
    ctx = roofline.Ctx((8, 8, 8))
    assert ROLES["pdf2d"].work("pdf2d_kernel<true, false>", ctx) == (12 * 512 + 80000, 8 * 512)
    assert ROLES["pdf2d"].work("pdf2d_kernel<false, true>", ctx) == (8 * 512 + 80000, 8 * 512)


def test_launch_check_flags_a_mismatch():
    from harness.trace import Op

    ops = [Op("row_moments_kernel(...)", "own", 0, 1), Op("mystery_kernel()", "own", 1, 1)]
    rows = {r[0]: r[1:] for r in roofline.launch_check(ops, list(ROLES.values()),
                                                       {"row_moments": 2})}
    assert rows["row moments"] == (1, 2)
    assert rows["unmatched"] == (1, 0)
