"""The host side of the joint-histogram kernel B8, on the CPU.

The kernel (csrc/pdf2d_kernels.cu) bins float32 samples against float32
thresholds that the host builds from the float64 edges
(``cuda_kernels._pdf2d_axis``), and takes a float32 guess of the bin
without reading them where the host's bound certifies it. Here the
thresholds and the kernel's arithmetic (``_threshold_bins``, its plain
mirror) are held to the float64 compare of ``bin_index`` (np.histogram's
semantics), exactly, on the float32 neighbours of every edge; and the launch
helpers to what the kernel assumes. B8 against fava_tpu stays in
tests/test_torch_kernels.py and tests/test_torch_volume.py.
"""

import numpy as np
import pytest
import torch

from fava_tpu_torch.ops import cuda_kernels as ck

F32_MAX = float(np.finfo(np.float32).max)


def _neighbours(edges):
    """Every float32 around each edge: the nearest, and 1 and 2 steps below
    and above it, with the float32 rounding of the edge itself."""
    with np.errstate(over="ignore"):
        e32 = np.asarray(edges, dtype=np.float64).astype(np.float32)
    out = [e32]
    for direction in (-np.inf, np.inf):
        step = e32
        for _ in range(2):
            step = np.nextafter(step, np.float32(direction))
            out.append(step)
    return np.concatenate(out)


EDGES = {
    "linspace": np.linspace(0.4962, 1.6031, 101),
    "linspace negative": np.linspace(-1.2998, 1.2999, 101),
    "representable": np.linspace(-2.0, 2.0, 65),
    "between floats": np.linspace(0.1, 0.7, 31) + 1e-9,
    "around zero": np.linspace(-1e-3, 1e-3, 41),
    "large": np.linspace(1e30, 3e30, 17),
    "tiny": np.linspace(1e-30, 2e-30, 9),
    "wide": np.linspace(-3e38, 3e38, 11),
    "beyond float32": np.array([-1e39, -1.0, 0.0, 1.0, 1e39]),
    "geometric": np.geomspace(1e-3, 1e3, 61),
    "random sorted": np.sort(np.random.default_rng(4).normal(0.0, 1.0, 50)),
    "repeated edges": np.array([0.0, 0.25, 0.25, 0.25, 0.5, 0.9, 0.9]),
    "repeated last": np.array([0.0, 0.1, 0.3, 0.3]),
    "one bin": np.array([0.2, 0.3]),
    "infinite": np.array([-np.inf, -1.0, 0.0, 2.5, np.inf]),
    "all equal": np.array([0.3, 0.3, 0.3]),
}


def _values(edges, seed=0):
    e = np.asarray(edges, dtype=np.float64)
    finite = e[np.isfinite(e)]
    lo, hi = (finite.min(), finite.max()) if finite.size else (-1.0, 1.0)
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):
        rand = rng.uniform(max(lo - 0.1 * (hi - lo), -F32_MAX), min(hi + 0.1 * (hi - lo), F32_MAX),
                           4000).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, F32_MAX, -F32_MAX], dtype=np.float32)
    return np.concatenate([_neighbours(finite), rand, special])


@pytest.mark.parametrize("e", [0.0, -0.0, 1.0, 0.1, -0.1, 1.0 + 2.0**-30, 3e38, -3e38, 1e39, -1e39,
                               1e-46, -1e-46, 2.0**-149, 123456789.123])
def test_float32_rounding_of_an_edge(e):
    up, down = ck._ceil_f32(np.array([e]))[0], ck._floor_f32(np.array([e]))[0]
    with np.errstate(over="ignore"):
        assert float(up) >= e and float(np.nextafter(up, np.float32(-np.inf))) < e
        assert float(down) <= e and float(np.nextafter(down, np.float32(np.inf))) > e


@pytest.mark.parametrize("case", sorted(EDGES))
def test_thresholds_equal_the_float64_compare(case):
    """v >= e[b] exactly when v >= t[b], and v <= e[nb] exactly when
    v <= hi, for every float32 v tried (each edge's neighbours above all)."""
    e = EDGES[case]
    head, t = ck._pdf2d_axis(e)
    assert t.dtype == np.float32 and t.size == e.size - 1 and head[0] == t[0]
    v = _values(e)
    v64 = v.astype(np.float64)
    for b in range(t.size):
        np.testing.assert_array_equal(v >= t[b], v64 >= e[b])
    np.testing.assert_array_equal(v <= head[1], v64 <= e[-1])


@pytest.mark.parametrize("case", sorted(EDGES))
def test_kernel_bins_equal_bin_index(case):
    """The kernel's float32 bins (guess certified by the head, else the
    threshold search) against np.histogram's float64 bin."""
    e = EDGES[case]
    head, t = ck._pdf2d_axis(e)
    v = torch.from_numpy(_values(e, seed=len(case)))
    got = ck._threshold_bins(v, head, t)
    ref = ck.bin_index(v.double(), torch.from_numpy(e))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("lo,hi,nb", [(0.4962, 1.6031, 100), (-1.2998, 1.2999, 100), (0.0, 1.0, 100),
                                      (-3.0, 3.0, 57), (1e6, 2e6, 1000), (0.9, 1.6, 40),
                                      (-1e-20, 1e-20, 100), (0.0, 1.0, 5000)])
def test_uniform_edges_take_the_guess_almost_always(lo, hi, nb):
    """On linspace edges the certified window leaves the guess to all but
    2 fast_lo of the samples (< 1%), and those still bin exactly."""
    e = np.linspace(lo, hi, nb + 1)
    head, t = ck._pdf2d_axis(e)
    assert 0.0 < head[3] < 5e-3 and head[4] == ck._floor_f32(np.array([1.0 - float(head[3])]))[0]
    v = torch.from_numpy(np.random.default_rng(nb).uniform(lo, hi, 20000).astype(np.float32))
    assert torch.equal(ck._threshold_bins(v, head, t), ck.bin_index(v.double(), torch.from_numpy(e)))


@pytest.mark.parametrize("case", ["geometric", "random sorted", "infinite", "all equal", "beyond float32"])
def test_far_from_uniform_edges_always_search(case):
    head, _ = ck._pdf2d_axis(EDGES[case])
    assert (head[2], head[3], head[4]) == (0.0, 1.0, 0.0)


@pytest.mark.parametrize("seed", range(6))
def test_random_linspace_edges_match_bin_index(seed):
    """Random ranges and bin counts: each edge's neighbours and random
    samples, bins equal to the float64 compare."""
    rng = np.random.default_rng(100 + seed)
    scale = 10.0 ** rng.uniform(-8, 8)
    lo = rng.normal() * scale
    e = np.linspace(lo, lo + rng.uniform(0.01, 10.0) * scale, int(rng.integers(1, 400)) + 1)
    head, t = ck._pdf2d_axis(e)
    v = torch.from_numpy(_values(e, seed))
    assert torch.equal(ck._threshold_bins(v, head, t), ck.bin_index(v.double(), torch.from_numpy(e)))


def test_joint_histogram_of_kernel_bins_equals_the_plain_twin():
    """Bins from the thresholds, joined as the kernel joins them, counted and
    weighted: equal to ``_pdf2d_plain`` on smooth-field samples with NaN,
    edge values and out-of-range samples."""
    rng = np.random.default_rng(8)
    z = np.linspace(0.0, 1.0, 3000)
    x = (1.0 + 0.1 * z + 0.01 * rng.standard_normal(z.size)).astype(np.float32)
    y = (0.3 * np.cos(4 * np.pi * z)).astype(np.float32)
    xe, ye = np.linspace(float(x.min()), float(x.max()), 41), np.linspace(-0.25, 0.31, 23)
    x[:3] = [np.nan, xe[5], xe[-1]]
    y[3:6] = [ye[0], ye[-1], np.inf]
    w = rng.random(z.size).astype(np.float32)
    table = ck._pdf2d_table(xe, ye)
    h = ck.PDF2D_AXIS_HEAD
    hx, hy = table[:h], table[h:2 * h]
    tx, ty = table[2 * h:2 * h + 40], table[2 * h + 40:]
    bx = ck._threshold_bins(torch.from_numpy(x), hx, tx)
    by = ck._threshold_bins(torch.from_numpy(y), hy, ty)
    keep = (bx >= 0) & (by >= 0)
    flat = (bx * 22 + by)[keep]
    counts = torch.bincount(flat, minlength=40 * 22).reshape(40, 22)
    sums = torch.zeros(40 * 22, dtype=torch.float64).index_add_(
        0, flat, torch.from_numpy(w).double()[keep]).reshape(40, 22)
    xt, yt, wt = (torch.from_numpy(a).double() for a in (x, y, w))
    assert torch.equal(counts, ck._pdf2d_plain(xt, yt, xe, ye))
    torch.testing.assert_close(sums, ck._pdf2d_plain(xt, yt, xe, ye, wt), rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# The launch


@pytest.mark.parametrize("nbx,nby,weighted,shared,smem", [
    (100, 100, False, True, 40000 + 4 * 210),
    (100, 100, True, True, 80000 + 4 * 210),
    (37, 23, False, True, 37 * 23 * 4 + 4 * 70),
    (170, 170, True, False, 4 * 350),
    (300, 300, False, False, 4 * 610),
    (238, 238, False, True, 238 * 238 * 4 + 4 * 486),
])
def test_layout_puts_the_histogram_in_shared_memory_when_it_fits(nbx, nby, weighted, shared, smem):
    assert ck._pdf2d_layout(nbx, nby, weighted, 232448) == (shared, smem)


def test_layout_raises_when_not_even_the_table_fits():
    with pytest.raises(ValueError, match="do not fit"):
        ck._pdf2d_layout(40000, 20000, False, 232448)


@pytest.mark.parametrize("n,bps,sms,expect", [
    (0, 2, 132, 1), (1, 2, 132, 1), (PDF2D_TILE := ck.PDF2D_TILE, 2, 132, 1),
    (16 * ck.PDF2D_TILE + 1, 2, 132, 2), (134217728, 2, 132, 264), (140050432, 3, 132, 396),
    (10007, 2, 132, 3), (200003, 3, 132, 49),
])
def test_blocks_fill_one_wave_at_most(n, bps, sms, expect):
    blocks = ck._pdf2d_blocks(n, bps, sms)
    assert blocks == expect
    assert blocks <= max(1, bps * sms) or blocks == -(-n // ck.PDF2D_BLOCK_SAMPLES)
    warps = ck.PDF2D_THREADS // 32
    # Every warp of the launch has a tile unless the card is full.
    assert blocks == bps * sms or (blocks - 1) * warps * ck.PDF2D_TILE < max(n, 1)


def _block_samples(n, blocks):
    """The most samples one block of a ``blocks``-block launch takes: the
    kernel's warps walk the tiles with a stride of all the grid's warps."""
    warps = ck.PDF2D_THREADS // 32
    tiles = -(-n // ck.PDF2D_TILE)
    return warps * -(-tiles // (blocks * warps)) * ck.PDF2D_TILE


@pytest.mark.parametrize("n", [1, 134217728, 140050432, 1 << 33, (1 << 40) + 12345, 1 << 45])
@pytest.mark.parametrize("bps,sms", [(2, 132), (3, 132), (1, 1)])
def test_a_block_never_takes_2_to_the_32_samples(n, bps, sms):
    """Its uint32 counts cannot wrap; and the blocks cover every tile."""
    blocks = ck._pdf2d_blocks(n, bps, sms)
    assert _block_samples(n, blocks) < 1 << 32
    assert blocks * _block_samples(n, blocks) >= n


def test_constants_match_the_kernel_source():
    src = (ck._build.CSRC / "pdf2d_kernels.cu").read_text()
    assert f"constexpr int kThreads = {ck.PDF2D_THREADS};" in src
    assert f"constexpr int kSpan = {ck.PDF2D_SPAN};" in src
    assert f"constexpr int kAxisHead = {ck.PDF2D_AXIS_HEAD};" in src
