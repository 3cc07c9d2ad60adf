"""The shell-binning walk (csrc/shell_bins.cuh), on the CPU.

Every Hermitian shell binning on the card (B6/B10, K4/B4, B11a/B11b, B9)
walks rows along z: each cell's shell from a table of class thresholds,
lanes' spans of consecutive cells after a masked head, runs of one shell
summed per lane, and the runs that reach a span's end merged across lanes.
Here that decomposition is mirrored in numpy and held to the plain twins
(``_shell_bin_folded_plain``, ``_onepass_plain``, ``_powers_fused_plain``)
to rtol 1e-10 in float64 (the same sums in another order), the counts
exactly; the thresholds to the float32 formula bit for bit; the heads'
alignment claims on every row; the launch helpers to what the kernels
assume; and the constants to the sources. Past SHELL_MAX_BINS shells (the
wide walk) the thresholds are the exact shells of the integer k^2, held
to the integer rule exactly, and the walk to the twins as above. The
kernels themselves run in tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fava_tpu_torch.ops import cuda_kernels as ck

CSRC = Path(ck.__file__).resolve().parent.parent / "csrc"
H100_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin of sm_90
MAX_GROUPS = 2  # kMaxGroups: float4 groups of a lane's span in shell_walk_kernel
# B9's layouts: (cells of a row's 16-byte unit, kSpan: cells of a lane's span).
B9_LAYOUTS = {"interleaved": (2, 2), "planar": (4, 4)}
INT_MAX = 2**31 - 1


def _cell_class(k2, nbins):
    """The kernels' formula: floor(sqrtf(k2) + 0.5), nbins beyond the
    last shell (k > nbins - 0.5), in f32 up to SHELL_MAX_BINS shells and
    in f64 past them (the wide walk)."""
    dt = np.float32 if nbins <= ck.SHELL_MAX_BINS else np.float64
    k = np.sqrt(np.asarray(k2, dtype=dt))
    cls = np.minimum(np.floor(k + dt(0.5)).astype(np.int64), nbins - 1)
    return np.where(k <= dt(nbins) - dt(0.5), cls, nbins)


def _thresholds(nbins):
    """class_thresholds: thr[s] the least k2 of class >= s, s = 0 .. nbins + 1."""
    thr = [0]
    for s in range(1, nbins + 1):
        g = s * s - s + 1
        while g > 0 and _cell_class(g - 1, nbins) >= s:
            g -= 1
        while _cell_class(g, nbins) < s:
            g += 1
        thr.append(g)
    return np.array(thr + [INT_MAX], dtype=np.int64)


def _first_kz_outside(ij2, out):
    if ij2 >= out:
        return 0
    g = int(np.sqrt(np.float32(out - ij2)))
    while g > 0 and ij2 + (g - 1) ** 2 >= out:
        g -= 1
    while ij2 + g * g < out:
        g += 1
    return g


def _lane_spans(head, length, span):
    """(trip, lane) of each cell z = 0 .. length-1 of a walk whose lanes
    take ``span`` positions (q = z + head) each, 32 lanes a trip."""
    q = np.arange(length) + head
    return q // (32 * span), (q % (32 * span)) // span


def _walk_row(hist, values, ij2, head, nbins, thr, full_nz, span):
    """Adds one walk (cells z = 0 .. len-1 of ``values``, (C, nzr) float64)
    to hist as the kernels do: runs that end inside a lane's span alone,
    the last run of each lane's span merged with the other lanes' of its
    shell in that trip."""
    length = min(values.shape[1], _first_kz_outside(ij2, int(thr[nbins])))
    if length == 0:
        return
    z = np.arange(length)
    cls = np.searchsorted(thr, ij2 + z * z, side="right") - 1
    assert (cls < nbins).all()
    wz = np.where((z == 0) | ((full_nz % 2 == 0) & (z == full_nz // 2)), 1.0, 2.0)
    trip, lane = _lane_spans(head, length, span(head + length))
    runs = {}
    for t, ln in set(zip(trip.tolist(), lane.tolist())):
        mine = (trip == t) & (lane == ln)
        last = cls[mine].max()
        for c in np.unique(cls[mine]):
            cells = mine & (cls == c)
            key = (t, -1 if c == last else ln, int(c))
            runs[key] = runs.get(key, 0.0) + (values[:, z[cells]] * wz[cells]).sum(axis=1)
    for (_, _, c), s in runs.items():
        hist[:, c] += s


def _folded_span(cells):
    """shell_walk_kernel: 4m cells a lane, m = 1 .. kMaxGroups sized to the walk."""
    return 4 * min(MAX_GROUPS, -(-cells // 128))


def _mirror_folded(vols, nbins, full_nx, full_ny, full_nz, counts, base=0):
    """K4/B4/B11a/B11b's walk over a folded (nxh, rows, nzr) volume whose
    first float sits ``base`` floats past 16 bytes: (C, nbins)."""
    nxh, rows, nzr = vols[0].shape
    thr = _thresholds(nbins)
    mult = lambda idx, n: 1.0 if idx == 0 or (n % 2 == 0 and 2 * idx == n) else 2.0  # noqa: E731
    hist = np.zeros((len(vols) + counts, nbins))
    flat = [v.double().numpy().reshape(nxh * rows, nzr) for v in vols]
    for i in range(nxh):
        for j in range(rows):
            if 2 * j > full_ny:  # pad rows: never read
                continue
            r = i * rows + j
            vals = [np.full(nzr, mult(i, full_nx) * mult(j, full_ny))] if counts else []
            vals += [f[r] for f in flat]
            _walk_row(hist, np.stack(vals), i * i + j * j, (base + r * nzr) % 4, nbins, thr, full_nz,
                      _folded_span)
    return torch.from_numpy(hist)


def _own_wave(idx, n):
    return (0.0, 0.5 * n) if 2 * idx == n else (float(idx), 0.0)


def _partner_powers(w, kx, ky, kz, kz0, inv_k2):
    """B9's partner_powers on (3, 2, cells) float64 values: (total, longi)."""
    wr, wi = w[:, 0], w[:, 1]
    tot = 0.5 * ((wr[0] * wr[0] + wi[0] * wi[0]) + (wr[1] * wr[1] + wi[1] * wi[1])
                 + (wr[2] * wr[2] + wi[2] * wi[2]))
    reg_r = kx[0] * wr[0] + ky[0] * wr[1] + kz[0] * wr[2]
    reg_i = kx[0] * wi[0] + ky[0] * wi[1] + kz[0] * wi[2]
    nyq_r = kx[1] * wr[0] + ky[1] * wr[1] + kz[1] * wr[2]
    nyq_i = kx[1] * wi[0] + ky[1] * wi[1] + kz[1] * wi[2]
    p = np.where(kz0, (reg_r - nyq_r) ** 2 + (reg_i - nyq_i) ** 2,
                 (reg_r * reg_r + reg_i * reg_i) + (nyq_r * nyq_r + nyq_i * nyq_i))
    return tot, p * inv_k2


def _mirror_powers(re, im, nbins, full_nz, layout, base=0):
    """B9's walk over the folded rows of the stacked transforms: each
    cell's four partners with their own wavenumber splits, summed as
    ((i, j) + (-i, j)) + ((i, -j) + (-i, -j)): (3, nbins) [counts, total,
    longi]."""
    _, nx, ny, nzr = re.shape
    w = np.stack([re.double().numpy(), im.double().numpy()], axis=1)  # (3, 2, nx, ny, nzr)
    thr = _thresholds(nbins)
    z = np.arange(nzr)
    kz = (np.where(2 * z == full_nz, 0.0, z), np.where(2 * z == full_nz, 0.5 * full_nz, 0.0))
    hist = np.zeros((3, nbins))
    for i in range(nx // 2 + 1):
        for j in range(ny // 2 + 1):
            xp, yp = 0 < 2 * i < nx, 0 < 2 * j < ny
            kx, ky = _own_wave(i, nx), _own_wave(j, ny)
            parts = [(i, j, kx, ky), (nx - i, j, (-float(i), 0.0), ky),
                     (i, ny - j, kx, (-float(j), 0.0)), (nx - i, ny - j, (-float(i), 0.0), (-float(j), 0.0))]
            on = (True, xp, yp, xp and yp)
            inv_k2 = 1.0 / np.maximum(i * i + j * j + z * z, 1.0)
            t, lo = [], []
            for (pi, pj, pkx, pky), present in zip(parts, on):
                tp, lp = _partner_powers(w[:, :, pi % nx, pj % ny], pkx, pky, kz, z == 0, inv_k2)
                t.append(tp if present else 0.0 * tp)
                lo.append(lp if present else 0.0 * lp)
            mxy = (2.0 if xp else 1.0) * (2.0 if yp else 1.0)
            vals = np.stack([np.full(nzr, mxy), (t[0] + t[1]) + (t[2] + t[3]),
                             (lo[0] + lo[1]) + (lo[2] + lo[3])])
            unit, span = B9_LAYOUTS[layout]
            head = (base + (i * ny + j) * nzr) % unit
            _walk_row(hist, vals, i * i + j * j, head, nbins, thr, full_nz, lambda cells: span)
    return torch.from_numpy(hist)


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(shape)).float()


# ---------------------------------------------------------------------------
# Thresholds and walk lengths


@pytest.mark.parametrize("nbins", [1, 2, 3, 7, 254, 255, 511, 4095])
def test_class_thresholds_equal_the_float32_formula(nbins):
    thr = _thresholds(nbins)
    # Every k2 up to 2^18, and each threshold's neighbours beyond.
    near = (thr[1 : nbins + 1, None] + np.arange(-8, 9)[None, :]).ravel()
    k2 = np.unique(np.concatenate([np.arange(min((nbins + 1) ** 2 + 64, 1 << 18)), near[near >= 0]]))
    assert np.array_equal(np.searchsorted(thr, k2, side="right") - 1, _cell_class(k2, nbins))
    assert thr[0] == 0 and (np.diff(thr) > 0).all()


@pytest.mark.parametrize("nbins", [4096, 8191, 26753, ck.WALK_MAX_BINS])
def test_wide_class_thresholds_are_the_exact_shells(nbins):
    """The wide walk's thresholds: thr[s] = s^2 - s + 1, the least integer
    k^2 above (s - 1/2)^2, found by the f64 formula from the same guess;
    s^2 + s (1/(8s) below the next half-integer) stays in shell s, where
    f32 already moves it to s + 1. Every k^2 a walk steps to (the last
    shell plus a lane span's overrun of 8 positions) fits int32."""
    thr = _thresholds(nbins)
    s = np.arange(1, nbins + 1)
    assert np.array_equal(thr[1 : nbins + 1], s * s - s + 1)
    assert np.array_equal(_cell_class(s * s + s, nbins), np.minimum(s, nbins))
    assert np.array_equal(_cell_class(s * s - s, nbins), s - 1)
    top = nbins * nbins - nbins  # k = nbins - 1/2 - 1/(8 nbins): the last inside
    assert _cell_class(top, nbins) == nbins - 1 and _cell_class(top + 1, nbins) == nbins
    big = s[s >= 2048]
    assert (np.floor(np.sqrt((big * big + big).astype(np.float32)) + np.float32(0.5)) == big + 1).all()
    out = int(thr[nbins])
    g = _first_kz_outside(0, out)
    assert (g + 8) ** 2 + 2 * (g + 8) + 1 < 2**31


@pytest.mark.parametrize("nbins", [1, 2, 30, 255, 4096, 8191, ck.WALK_MAX_BINS])
def test_first_kz_outside_ends_each_walk_at_the_last_shell(nbins):
    out = int(_thresholds(nbins)[nbins])
    for ij2 in list(range(0, 3 * out, max(1, out // 50))) + [out - 1, out, out + 1]:
        g = _first_kz_outside(ij2, out)
        inside = _cell_class(ij2 + np.arange(g + 40) ** 2, nbins) < nbins
        assert inside[:g].all() and not inside[g:].any()
        assert ij2 >= out or ij2 + (g + 8) ** 2 < 2**31  # a lane's overrun past the walk


# ---------------------------------------------------------------------------
# Heads: every float4 load on 16 bytes, every cell of the walk once


@pytest.mark.parametrize("nzr", [1, 2, 3, 4, 5, 33, 256, 257, 258, 513])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_planar_rows_heads_cover_each_cell_once(nzr, base):
    """Float rows (K4/B4/B11, B6/B10, B9's planar stacks) at odd and even
    nzr: the row at float offset o = base + r nzr takes head o % 4; the
    lanes' float4 groups start on 16 bytes and hold each cell once."""
    for r in range(8):
        o = base + r * nzr
        head = o % 4
        length = nzr
        span = _folded_span(head + length)
        q = np.arange(head + length)
        starts = q[q % 4 == 0]
        assert ((o - head + starts) % 4 == 0).all()  # float4 addresses on 16 bytes
        cells = np.concatenate([s + np.arange(4) - head for s in starts])
        assert np.array_equal(np.sort(cells[(cells >= 0) & (cells < length)]), np.arange(length))
        trip, lane = _lane_spans(head, length, span)
        assert (lane < 32).all() and (np.diff(trip * 32 + lane) >= 0).all()


@pytest.mark.parametrize("shape", [(4, 4, 1), (6, 2, 2), (8, 6, 3), (16, 10, 33), (4, 4, 257),
                                   (2, 34, 9), (8, 8, 258)])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_powers_partner_rows_share_the_head(shape, base):
    """B9's streams of a folded row (i, j): its three components and four
    partners. Interleaved (8-byte cells): every stream's rows start at the
    (i, j) row's offset from 16 bytes. Planar (4-byte floats): the x-partner
    and the components do; a y-partner does exactly when (ny - 2j) nzr is
    a multiple of 4 (the kernel's vec_y), else it takes scalar loads."""
    nx, ny, nzr = shape
    cells = nx * ny * nzr
    for i in range(nx // 2 + 1):
        for j in range(ny // 2 + 1):
            xp, yp = 0 < 2 * i < nx, 0 < 2 * j < ny
            p00 = (i * ny + j) * nzr
            rows = [p00, ((nx - i) * ny + j) * nzr if xp else None,
                    (i * ny + ny - j) * nzr if yp else None,
                    ((nx - i) * ny + ny - j) * nzr if xp and yp else None]
            vec_y = (ny - 2 * j) * nzr % 4 == 0
            for c in range(3):
                for p, off in enumerate(rows):
                    if off is None:  # no mirror row: nothing loaded
                        continue
                    o = c * cells + off
                    assert (base + o) % 2 == (base + p00) % 2  # interleaved
                    assert ((base + o) % 4 == (base + p00) % 4) == (p < 2 or vec_y)  # planar


# ---------------------------------------------------------------------------
# The walk against the twins


FOLDED_CASES = [((8, 6, 10), 4), ((16, 12, 18), 8), ((4, 4, 598), 298), ((6, 2, 300), 40),
                ((2, 2, 64), 1), ((10, 8, 256), 127)]


@pytest.mark.parametrize("full,nbins", FOLDED_CASES)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("base", [0, 3])
def test_folded_walk_equals_the_plain_twin(full, nbins, channels, base):
    """K4 (2 channels) and B4 (1) over the folded rows, NaN in pad rows
    past ny/2 (B11b): equal to _shell_bin_folded_plain on the unpadded fold."""
    nx, ny, nz = full
    fshape = (nx // 2 + 1, ny // 2 + 1, nz // 2 + 1)
    vols = [_rand(fshape, seed) for seed in range(channels)]
    padded = [torch.cat([v, torch.full((fshape[0], 3, fshape[2]), float("nan"))], dim=1) for v in vols]
    got = _mirror_folded(padded, nbins, nx, ny, nz, counts=False, base=base)
    ref = ck._shell_bin_folded_plain(vols[0].double(), vols[1].double() if channels == 2 else None,
                                     nbins, ny, nz)
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-300)


WIDE_CASES = [((8194, 4, 4), 4096), ((16384, 2, 4), 8191), ((8194, 2, 2), 8191)]


@pytest.mark.parametrize("full,nbins", WIDE_CASES)
def test_wide_walk_equals_the_plain_twin(full, nbins):
    """The wide walk (past SHELL_MAX_BINS shells) over folds of elongated
    volumes: B11a's counts equal the static counts exactly, K4's and B4's
    sums the twins' (the exact shells of the integer k^2 on both sides)."""
    nx, ny, nz = full
    fshape = (nx // 2 + 1, ny // 2 + 1, nz // 2 + 1)
    vols = [_rand(fshape, 3 + s) for s in range(2)]
    got = _mirror_folded(vols, nbins, nx, ny, nz, counts=True, base=2)
    ref = ck._onepass_plain(*(v.double() for v in vols), nbins, nx, ny, nz)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[0], ck._static_counts((nx, ny, nz // 2 + 1), nbins, nz, "cpu"))
    torch.testing.assert_close(got[1:], ref[1:], rtol=1e-10, atol=1e-300)
    one = _mirror_folded(vols[1:], nbins, nx, ny, nz, counts=False)
    torch.testing.assert_close(one, ref[2:], rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("full,nbins", FOLDED_CASES)
def test_onepass_walk_counts_exactly(full, nbins):
    """B11a: the count channel mx my wz summed a run at a time equals the
    static counts exactly; the sums equal _onepass_plain's."""
    nx, ny, nz = full
    fshape = (nx // 2 + 1, ny // 2 + 1 + 5, nz // 2 + 1)
    vols = [_rand(fshape, 7 + s) for s in range(2)]
    for v in vols:
        v[:, ny // 2 + 1:] = float("nan")
    got = _mirror_folded(vols, nbins, nx, ny, nz, counts=True, base=1)
    ref = ck._onepass_plain(*(v.double() for v in vols), nbins, nx, ny, nz)
    assert torch.equal(got[0], ref[0])
    assert torch.equal(got[0], ck._static_counts((nx, ny, nz // 2 + 1), nbins, nz, "cpu"))
    torch.testing.assert_close(got[1:], ref[1:], rtol=1e-10, atol=1e-300)


POWERS_CASES = [((4, 4, 4), 1), ((8, 6, 5), 3), ((16, 10, 9), 7), ((2, 34, 9), 16), ((6, 2, 70), 34),
                ((4, 4, 598), 298), ((8, 8, 16), 2)]


@pytest.mark.parametrize("full,nbins", POWERS_CASES)
@pytest.mark.parametrize("layout,base", [("interleaved", 0), ("interleaved", 1), ("planar", 0),
                                         ("planar", 3)])
def test_powers_walk_equals_the_plain_twin(full, nbins, layout, base):
    """B9: partners in the fold's order with their own Nyquist splits (x
    and y extents of 2 have no mirror rows; even nz a Nyquist plane),
    spans of kSpan cells after the layout's head: counts exact, sums
    equal to _powers_fused_plain."""
    nx, ny, nz = full
    rng = np.random.default_rng(sum(full))
    vel = torch.from_numpy(rng.standard_normal((3, nx, ny, nz)))
    spec = torch.fft.rfftn(vel, dim=(1, 2, 3), norm="forward").to(torch.complex64)
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    got = _mirror_powers(re, im, nbins, nz, layout, base)
    ref = ck._powers_fused_plain(re.double(), im.double(), nbins, nz)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1:], ref[1:], rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("layout,base", [("interleaved", 1), ("planar", 3)])
def test_wide_powers_walk_equals_the_plain_twin(layout, base):
    """B9 on the wide walk (4096 shells of an (8194, 2, 3) volume): counts
    exact, sums equal to _powers_fused_plain."""
    test_powers_walk_equals_the_plain_twin((8194, 2, 3), 4096, layout, base)


# ---------------------------------------------------------------------------
# The launch: one wave, histograms that fit, every caller on it


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_block_warps_fit_the_histograms(channels):
    """For every nbins the kernels take, a block of bin_block_warps warps
    fits the H100's shared memory, one more warp would not (unless at
    BIN_MAX_WARPS), and at least one always does."""
    nbins = np.arange(1, ck.SHELL_MAX_BINS + 1)
    for nb in nbins:
        warps = ck.bin_block_warps(channels, int(nb), H100_SMEM_OPTIN)
        assert 1 <= warps <= ck.BIN_MAX_WARPS
        assert ck.walk_smem_bytes(warps, channels, int(nb)) <= H100_SMEM_OPTIN
        assert warps == ck.BIN_MAX_WARPS or ck.walk_smem_bytes(warps + 1, channels, int(nb)) > H100_SMEM_OPTIN
    assert ck.bin_block_warps(channels, 255, H100_SMEM_OPTIN) == ck.BIN_MAX_WARPS
    assert ck.bin_block_warps(3, ck.SHELL_MAX_BINS, H100_SMEM_OPTIN) == 2


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_wide_walk_blocks_hold_the_thresholds_alone(channels):
    """Past SHELL_MAX_BINS shells a block of BIN_MAX_WARPS warps keeps
    only the nbins + 2 int thresholds in shared memory, which fit up to
    WALK_MAX_BINS."""
    for nb in list(range(ck.SHELL_MAX_BINS + 1, ck.WALK_MAX_BINS + 1, 997)) + [ck.WALK_MAX_BINS]:
        assert ck.bin_block_warps(channels, nb, H100_SMEM_OPTIN) == ck.BIN_MAX_WARPS
        assert ck.walk_smem_bytes(ck.BIN_MAX_WARPS, channels, nb) == (nb + 2) * 4 <= H100_SMEM_OPTIN


@pytest.mark.parametrize("nbins", [0, -1, ck.WALK_MAX_BINS + 1, 10**6])
def test_nbins_beyond_the_kernels_raise_a_named_error(nbins):
    assert ck.bin_block_warps(2, nbins, H100_SMEM_OPTIN) == 0
    with pytest.raises(ValueError, match="WALK_MAX_BINS"):
        ck._check_bins("k", nbins)


@pytest.mark.parametrize("row_k2", [ck.WALK_MAX_K2 + 1, 2 * 32768**2, 10**12])
def test_rows_beyond_int32_raise_a_named_error(row_k2):
    with pytest.raises(ValueError, match="WALK_MAX_BINS"):
        ck._check_bins("k", 255, row_k2)


@pytest.mark.parametrize("nbins", [1, 255, ck.SHELL_MAX_BINS, ck.SHELL_MAX_BINS + 1, 8191,
                                   ck.WALK_MAX_BINS])
def test_nbins_within_the_kernels_pass(nbins):
    ck._check_bins("k", nbins, ck.WALK_MAX_K2)


@pytest.mark.parametrize("nwalks,warps,bps,sms,expect", [
    (0, 8, 4, 132, 1), (1, 8, 4, 132, 1), (257 * 257, 8, 6, 132, 792), (257 * 264, 8, 2, 132, 264),
    (257 * 257, 1, 3, 132, 396), (100, 3, 4, 132, 34), (16, 8, 1, 1, 1),
])
def test_walk_grid_is_one_wave(nwalks, warps, bps, sms, expect):
    blocks = ck._wave_blocks(nwalks, warps, bps, sms)
    assert blocks == expect
    assert blocks <= max(1, bps * sms)
    assert blocks * warps >= nwalks or blocks == bps * sms


class _Lib:
    def __getattr__(self, name):
        return name


@pytest.fixture()
def launches(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: each walk-grid request and
    each launch recorded, nothing run."""
    seen = {"walk": [], "launch": []}
    monkeypatch.setattr(ck, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(ck, "_check_cuda", lambda name, *t, dtype=None: None)
    monkeypatch.setattr(ck._build, "library", lambda: _Lib())

    def walk_blocks(entry, args, channels, nwalks, nbins, device):
        seen["walk"].append((entry, tuple(args), channels, nwalks, nbins))
        return 77

    monkeypatch.setattr(ck, "_walk_blocks", walk_blocks)
    monkeypatch.setattr(ck, "_launch",
                        lambda kernel, dev, fn, *a, wrote=(): seen["launch"].append((kernel, fn, a[-1])))
    return seen


def test_every_shell_binning_launches_one_wave_of_the_walk(launches):
    assert not hasattr(ck, "_bin_blocks")
    fold = torch.zeros((5, 8, 5))
    ck.shell_bin_values_folded(fold, fold, 3, 8, 8)
    ck.shell_bin_values_folded_1ch(fold, 3, 8, 8)
    ck.shell_bin_values_folded_rows(fold, fold, 3, 8, 8, 8)
    ck.shell_bin_sums_folded_onepass(fold, fold, 3, 8, 8, 8)
    spec = torch.view_as_real(torch.zeros((3, 8, 8, 5), dtype=torch.complex64))
    ck.shell_bin_powers_fused(spec[..., 0], spec[..., 1], 3, 8)
    planar = torch.zeros((3, 8, 8, 5))
    ck.shell_bin_powers_fused(planar, planar.clone(), 3, 8)
    vol = torch.zeros((7, 6, 4))
    ck.shell_bin_sums_unfolded(vol, vol, 3, 6)
    ck.shell_bin_values_rfft_chunk(vol, vol, 3, 9, 6, 2)
    folded = "fava_shell_bin_folded_blocks_per_sm"
    assert launches["walk"] == [
        (folded, (2, 0), 2, 40, 3), (folded, (1, 0), 1, 40, 3), (folded, (2, 0), 2, 40, 3),
        (folded, (2, 1), 3, 40, 3),
        ("fava_shell_bin_powers_fused_blocks_per_sm", (1,), 3, 25, 3),
        ("fava_shell_bin_powers_fused_blocks_per_sm", (0,), 3, 25, 3),
        ("fava_shell_bin_unfolded_blocks_per_sm", (2,), 2, 42, 3),
        ("fava_shell_bin_unfolded_blocks_per_sm", (2,), 2, 42, 3),
    ]
    assert [(k, blocks) for k, _, blocks in launches["launch"]] == [
        ("shell_bin_values_folded", 77), ("shell_bin_values_folded_1ch", 77),
        ("shell_bin_values_folded", 77), ("shell_bin_sums_folded_onepass", 77),
        ("shell_bin_powers_fused", 77), ("shell_bin_powers_fused", 77),
        ("shell_bin_sums_unfolded", 77), ("shell_bin_values_rfft_chunk", 77),
    ]


def _wrapper_calls(nb, fold, vol, spec, full_nx=9):
    return {"folded": lambda: ck.shell_bin_values_folded(fold, fold, nb, 8, 8),
            "onepass": lambda: ck.shell_bin_sums_folded_onepass(fold, fold, nb, 2 * fold.shape[0] - 2,
                                                                8, 8),
            "powers": lambda: ck.shell_bin_powers_fused(spec[..., 0], spec[..., 1], nb, 8),
            "unfolded": lambda: ck.shell_bin_sums_unfolded(vol, vol, nb, 6),
            "chunk": lambda: ck.shell_bin_values_rfft_chunk(vol, vol, nb, full_nx, 6, 2)}


@pytest.mark.parametrize("call", ["folded", "onepass", "powers", "unfolded", "chunk"])
def test_wrappers_refuse_nbins_beyond_the_kernels(launches, monkeypatch, call):
    """nbins past WALK_MAX_BINS, and rows whose kx^2 + ky^2 leaves int32
    (zero-stride volumes: nothing is allocated; B9's layout check is
    skipped for them), raise before a launch."""
    fold, vol = torch.zeros((5, 8, 5)), torch.zeros((7, 6, 4))
    spec = torch.view_as_real(torch.zeros((3, 8, 8, 5), dtype=torch.complex64))
    with pytest.raises(ValueError, match="WALK_MAX_BINS"):
        _wrapper_calls(ck.WALK_MAX_BINS + 1, fold, vol, spec)[call]()
    monkeypatch.setattr(ck, "_stack_layout", lambda name, re, im: 0)
    n = 100000  # kx^2 up to 50000^2 > 2^31
    fold = torch.zeros(1).expand(n // 2 + 1, 8, 5)
    vol = torch.zeros(1).expand(n, n, 4)
    spec = torch.view_as_real(torch.zeros(1, dtype=torch.complex64).expand(3, n, n, 5))
    with pytest.raises(ValueError, match="WALK_MAX_BINS"):
        _wrapper_calls(255, fold, vol, spec, full_nx=n + 7)[call]()
    assert not launches["launch"]


@pytest.mark.parametrize("call", ["folded", "onepass", "powers", "unfolded", "chunk"])
@pytest.mark.parametrize("nbins", [ck.SHELL_MAX_BINS + 1, 8191])
def test_wrappers_launch_the_wide_walk_past_4095_shells(launches, call, nbins):
    """Past SHELL_MAX_BINS shells every walk wrapper launches its kernel
    (the C entry takes the wide walk for that nbins), as below them."""
    fold, vol = torch.zeros((5, 8, 5)), torch.zeros((7, 6, 4))
    spec = torch.view_as_real(torch.zeros((3, 8, 8, 5), dtype=torch.complex64))
    _wrapper_calls(nbins, fold, vol, spec)[call]()
    assert [w[-1] for w in launches["walk"]] == [nbins]
    assert len(launches["launch"]) == 1 and launches["launch"][0][2] == 77


# ---------------------------------------------------------------------------
# The sources' constants


def _constant(text, name):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


def test_constants_match_the_sources():
    walk = (CSRC / "shell_bins.cuh").read_text()
    assert _constant(walk, "kBinMaxWarps") == ck.BIN_MAX_WARPS
    assert _constant(walk, "kMaxBins") == ck.SHELL_MAX_BINS
    assert (ck.SHELL_MAX_BINS + 1) ** 2 <= 2**24 < (ck.SHELL_MAX_BINS + 2) ** 2
    assert _constant(walk, "kMaxGroups") == MAX_GROUPS
    assert _constant(walk, "kMaxWideBins") == ck.WALK_MAX_BINS
    assert "nbins > kMaxBins ? 0 : warps * channels * (size_t)nbins * sizeof(double)" in walk
    assert "return hist + (nbins + 2) * sizeof(int);" in walk
    assert ck.walk_smem_bytes(8, 2, 255) == 8 * 2 * 255 * 8 + 257 * 4
    assert ck.walk_smem_bytes(8, 2, 8191) == 8193 * 4
    fused = (CSRC / "fused_spectra_kernels.cu").read_text()
    m = re.search(r"kSpan = kInterleaved \? (\d+) : (\d+);", fused)
    assert m and (int(m.group(1)), int(m.group(2))) == (B9_LAYOUTS["interleaved"][1],
                                                      B9_LAYOUTS["planar"][1])
    assert all(span % unit == 0 for unit, span in B9_LAYOUTS.values())  # whole float4s a span
    for old in ("warp_bin_add", "zero_hist", "flush_hist", "kBinThreads", "add_plain",
                "warp_hists_init", "warp_hists_flush"):
        for src in CSRC.glob("*.cu*"):
            assert old not in src.read_text(), (old, src.name)
