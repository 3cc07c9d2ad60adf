"""B12's cluster FFT plan and its plain twin, held on the CPU to numpy, to
the dense twin and to fava_tpu's fused z+y Pallas kernel.

``_zy_fft_plan`` is the split the CUDA kernel runs (csrc/dft_kernels.cu):
clusters of blocks, kz column slots per rank and pass, row batches and
column tiles, for every y and z extent 1..1024: mixed radix 2-16 for
extents with no prime factor above 7, Bluestein's algorithm (a chirp
axis: a 7-smooth circular convolution of length M >= 2n - 1) for the
others. ``_zy_rfft_fft_plain`` walks that plan in plain torch: the same
radix passes in the same order (on a chirp axis the premultiply, the DIF
passes, the filter, the inverse passes and the postmultiply), the same
packing of the real kz = 0 and kz = nz/2 columns into slot 0 (even nz) or
the same pairing of rows into one complex transform (odd nz), the same
split of rows and slots over the ranks and passes. It runs here in
float64. Tolerances:

* against np.fft (float64 FFTs in another order): rtol 1e-12 of the
  largest coefficient;
* against the dense twin ``_zy_rfft_plain`` (float64 DFT matrices, sums
  of up to 1024 terms): 1e-12 of the largest coefficient;
* against fava_tpu's Pallas kernel in interpret mode (float64 dense
  products): rtol 1e-9, atol 1e-9, as tests/test_torch_fused.py.

The kernel itself is held to these twins on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fava_tpu.experiments import pallas_dft
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu_torch.ops import cuda_kernels as ck

SMOOTH7 = [n for n in range(1, 1025) if ck._smooth7(n)]  # 1 .. 1024, no prime factor above 7
CHIRP = [n for n in range(1, 1025) if not ck._smooth7(n)]  # a prime factor above 7: Bluestein


@pytest.fixture()
def force_interpret():
    """fava_tpu's Pallas kernels in interpret mode, as its own tests run them."""
    pk.FORCE_INTERPRET = True
    yield
    pk.FORCE_INTERPRET = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref_re, ref_im, rtol):
    scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
    err = max(np.abs(got[0].numpy() - ref_re).max(), np.abs(got[1].numpy() - ref_im).max())
    assert err <= rtol * scale, (err, scale)


def _check_plan(plan, ny, nz):
    """The plan of (ny, nz) covers every slot and row once and fits its
    shared-memory budget (plan_ok in the kernel)."""
    n, odd = (nz + 1) // 2, nz % 2  # slots: nz/2 (slot 0 = kz 0 and nz/2) or (nz+1)/2
    assert plan.nslot == n and plan.nt == (nz if odd else nz // 2)
    c, parts = plan.cluster, plan.passes * plan.cluster
    assert c <= min(16, ny) and c & (c - 1) == 0 and plan.rows == -(-ny // c)
    # the ranks' rows cover the slab's rows once
    assert [a for r in range(c) for a in range(*plan.row_range(r))] == list(range(ny))
    assert max(b - a for a, b in map(plan.row_range, range(c))) == plan.rows
    assert plan.passes & (plan.passes - 1) == 0 and plan.passes <= n
    bounds = [plan.bound(u) for u in range(parts + 1)]
    assert bounds[0] == 0 and bounds[-1] == n and bounds == sorted(bounds)
    # the n slots cover the nz/2 + 1 kz columns once
    slots = [u for a, b in zip(bounds, bounds[1:]) for u in range(a, b)]
    assert slots == list(range(n))
    widths = {b - a for a, b in zip(bounds, bounds[1:])}
    assert max(widths) == plan.tile and widths <= {plan.tile - 1, plan.tile}
    assert all(b > a for a, b in zip(bounds[::c], bounds[c::c]))  # every pass has a slot
    assert n * (parts + 1) <= 1 << 16  # the slot owners' dividend, below 2^16 (Dv<false>)
    assert plan.es >= plan.tile and plan.es % 2 == 1 and plan.ws % 2 == 1
    assert 1 <= plan.batch <= plan.rows + odd and not (odd and plan.batch % 2)  # odd nz: pairs
    assert plan.work == (plan.batch // 2 if odd else plan.batch) * plan.ws
    pad = None if plan.chirp_z else ck._zy_pad(plan.mz, plan.radices_z)  # chirp rows: natural order
    assert plan.ws >= plan.mz + ((plan.mz - 1) >> pad if pad is not None else 0)
    assert plan.smem <= ck.ZY_SMEM_MAX <= 232448 and plan.smem % 8 == 0
    for radices, n_axis, m in ((plan.radices_z, plan.nt, plan.mz), (plan.radices_y, ny, plan.my)):
        assert set(radices) <= set(ck.ZY_RADICES) and int(np.prod(radices)) == m
        if ck._smooth7(n_axis):  # the axis's own length, or a chirp axis's convolution
            assert m == n_axis
        else:
            assert ck._smooth7(m) and 2 * n_axis - 1 <= m <= 2048 and len(radices) >= 2
    assert not plan.chirp_global or plan.chirp_z or plan.chirp_y
    if ny & (ny - 1) == 0 and nz & (nz - 1) == 0 and nz > 1:  # shifts: power-of-two batches and tiles
        assert plan.batch & (plan.batch - 1) == 0 and plan.rows % plan.batch == 0
        assert plan.tile & (plan.tile - 1) == 0 and (widths <= {0, 1} or widths == {plan.tile})
    assert len(plan.as_ints()) == 13 + 2 * ck.ZY_MAX_STAGES + 3


@pytest.mark.parametrize("ny", SMOOTH7)
def test_plan_covers_every_slot_and_row_once_and_fits(ny):
    for nz in SMOOTH7:
        _check_plan(ck._zy_fft_plan(ny, nz), ny, nz)


@pytest.mark.parametrize("n", CHIRP)
def test_chirp_plan_covers_every_slot_and_row_once_and_fits(n):
    """Every extent with a prime factor above 7, paired with 512 and with
    itself on y and z, has a plan: none falls back to another kernel."""
    for ny, nz in ((n, 512), (512, n), (n, n)):
        plan = ck._zy_fft_plan(ny, nz)
        _check_plan(plan, ny, nz)
        assert (plan.chirp_y, plan.chirp_z) == (not ck._smooth7(ny), not ck._smooth7(plan.nt))


@pytest.mark.parametrize("shape", [(512, 512), (1024, 1024), (256, 1024), (1024, 256)])
def test_plan_at_the_path_shapes(shape):
    """512^2 fits one pass with two blocks an SM; 1024^2 needs two passes."""
    plan = ck._zy_fft_plan(*shape)
    assert plan.cluster == 16
    if shape == (512, 512):
        assert plan.passes == 1 and plan.smem <= ck.ZY_SMEM_HALF
    if shape == (1024, 1024):
        assert plan.passes == 2


@pytest.mark.parametrize("n", [1, 2, 8, 64, 256, 512, 1024, 3, 5, 6, 7, 9, 12, 15, 45, 240, 375, 480,
                               1000, 2048, 1536])
def test_fft_positions_are_the_digit_reversal(n):
    radices = ck._radices(n)
    pos = ck._fft_positions(n, radices).numpy()
    assert sorted(pos.tolist()) == list(range(n))
    v = np.random.default_rng(n).standard_normal(n) + 1j * np.random.default_rng(n + 1).standard_normal(n)
    out = ck._dif_passes(_t(v), radices, ck._twiddles(n, torch.float64, "cpu")).numpy()
    np.testing.assert_allclose(out[pos], np.fft.fft(v), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [21, 45, 512, 1008, 2048])
def test_inverse_passes_undo_the_dif_passes(n):
    """The chirp route's inverse: the DIF passes' own tables, in reverse,
    on conjugated data, from digit-reversed to natural order."""
    radices = ck._radices(n)
    table = ck._twiddles(n, torch.float64, "cpu")
    rng = np.random.default_rng(n)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    back = ck._dit_passes(ck._dif_passes(_t(v), radices, table).conj(), radices, table).numpy()
    np.testing.assert_allclose(back, n * v.conj(), rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("n", [11, 13, 251, 509, 511, 1021])
def test_chirp_dft_matches_numpy(n):
    m = ck._chirp_length(n)
    radices = ck._radices(m)
    chirp, filt = ck._chirp_tables(n, m, radices, torch.float64, "cpu")
    rng = np.random.default_rng(n)
    v = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    got = ck._chirp_dft(_t(v), m, radices, ck._twiddles(m, torch.float64, "cpu"), chirp, filt).numpy()
    ref = np.fft.fft(v, axis=1)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_chirp_lengths():
    """M >= 2n - 1, 7-smooth, of the fewest passes, the power of two above
    where that is within 1/8 of the smallest such M, at most 2048."""
    assert [ck._chirp_length(n) for n in (11, 13, 251, 301, 401, 509, 1021)] == [
        21, 25, 512, 630, 840, 1024, 2048]
    for n in CHIRP:
        m = ck._chirp_length(n)
        assert ck._smooth7(m) and 2 * n - 1 <= m <= 2048 and len(ck._radices(m)) >= 2
    assert all(ck._chirp_length(n) == n for n in SMOOTH7)


# Edges: y or z extent 1 or 2, a rank of one row (ny = 16 over 16 ranks),
# ranks with no slot (fewer slots than ranks), the 1024^2 two-pass plan;
# mixed radix: odd ny, odd nz (rows paired, an odd rank's last row with
# zeros), ny = 3 and 7, uneven row shares (45 rows over 16 ranks), every
# radix, and the 1000^2 two-pass plan.
TWIN_SHAPES = [(2, 1, 2), (3, 2, 2), (2, 1, 8), (2, 8, 2), (2, 2, 1024), (2, 16, 4), (3, 64, 32),
               (2, 16, 64), (1, 1024, 1024), (2, 45, 35), (2, 3, 9), (2, 7, 7), (2, 1, 3), (2, 16, 3),
               (3, 15, 6), (2, 12, 14), (2, 10, 20), (2, 27, 18), (2, 49, 343), (1, 375, 12),
               (1, 1000, 1000)]


# Chirp axes: y only, z only (even and odd nz), both, nz = 1 (its z
# transform empty; the only route for it), ranks with no slot, the
# 2048-point convolution with its tables in global memory (1021 x 1019).
CHIRP_SHAPES = [(2, 22, 26), (2, 17, 38), (2, 13, 33), (2, 11, 1), (2, 1, 1), (2, 16, 1), (1, 64, 502),
                (2, 502, 8), (1, 23, 23), (3, 11, 22), (2, 1, 11), (1, 31, 62), (2, 33, 64), (1, 509, 9),
                (1, 1021, 1019)]


@pytest.mark.parametrize("shape", TWIN_SHAPES + CHIRP_SHAPES)
def test_fft_twin_matches_numpy_and_the_dense_twin(shape):
    v = np.random.default_rng(sum(shape)).standard_normal(shape)
    got = ck._zy_rfft_fft_plain(_t(v), ck._zy_fft_plan(shape[1], shape[2]))
    assert got[0].shape == (shape[0], shape[1], shape[2] // 2 + 1) and got[0].dtype == torch.float64
    ref = np.fft.fft(np.fft.rfft(v, axis=2), axis=1)
    _close(got, ref.real, ref.imag, 1e-12)
    dense = ck._zy_rfft_plain(_t(v))
    _close(got, dense[0].numpy(), dense[1].numpy(), 1e-12)


@pytest.mark.parametrize("ny,nz,cluster,passes", [(64, 64, 4, 2), (32, 128, 8, 4), (16, 32, 2, 8),
                                                  (8, 16, 8, 2), (45, 35, 4, 2), (30, 60, 8, 4),
                                                  (20, 9, 2, 4), (36, 27, 16, 2), (375, 6, 16, 2),
                                                  (22, 26, 4, 2), (45, 502, 8, 4), (23, 23, 2, 8),
                                                  (509, 9, 16, 2)])
def test_fft_twin_under_other_plans(ny, nz, cluster, passes):
    """Plans with several passes and other cluster sizes than the rule's:
    pass and rank boundaries in the slots, the tiles and the rows."""
    plan = ck._fit_plan(ny, nz, cluster, passes, ck.ZY_SMEM_MAX)
    assert plan is not None and (plan.cluster, plan.passes) == (cluster, passes)
    v = np.random.default_rng(ny + nz).standard_normal((2, ny, nz))
    ref = np.fft.fft(np.fft.rfft(v, axis=2), axis=1)
    _close(ck._zy_rfft_fft_plain(_t(v), plan), ref.real, ref.imag, 1e-12)


def test_fft_twin_matches_fava_tpu(force_interpret):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((4, 128, 128))
    assert pallas_dft.use_fused_zy(v.shape)
    re_ref, im_ref = pallas_dft.zy_rfft_planar(jnp.asarray(v))
    re, im = ck._zy_rfft_fft_plain(_t(v), ck._zy_fft_plan(128, 128))
    np.testing.assert_allclose(re.numpy(), np.asarray(re_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_ref), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("shape", [(2, 48, 30), (2, 45, 35), (2, 22, 26), (2, 17, 38), (2, 13, 33),
                                   (2, 11, 1)])
def test_mixed_radix_twin_matches_fava_tpu(force_interpret, shape):
    """Odd and non-power-of-two y and z, and chirp axes (22 and 33 have a
    factor 11; 13, 17 and 19 are prime; nz = 1), against fava_tpu's dense
    Pallas kernel in interpret mode (fava_tpu's own gate takes only
    multiples of 128; its kernel takes any shape)."""
    v = np.random.default_rng(sum(shape)).standard_normal(shape)
    re_ref, im_ref = pallas_dft.zy_rfft_planar(jnp.asarray(v))
    re, im = ck._zy_rfft_fft_plain(_t(v), ck._zy_fft_plan(*shape[1:]))
    np.testing.assert_allclose(re.numpy(), np.asarray(re_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_ref), rtol=1e-9, atol=1e-9)


def test_fft_twin_in_float32_is_close():
    """In float32 the twin carries log2 n roundings, as the kernel does."""
    v = np.random.default_rng(9).standard_normal((2, 256, 256))
    got = ck._zy_rfft_fft_plain(_t(v).float(), ck._zy_fft_plan(256, 256))
    assert got[0].dtype == torch.float32
    ref = np.fft.fft(np.fft.rfft(v, axis=2), axis=1)
    _close([g.double() for g in got], ref.real, ref.imag, 1e-6)


@pytest.mark.parametrize("shape", [(2, 64, 502), (2, 509, 18), (1, 127, 127)])
def test_chirp_twin_in_float32_is_close(shape):
    """A chirp axis adds two float32 transforms of length M and the chirp
    and filter products; it stays within the same 1e-6 of the largest
    coefficient (502 = 2 x 251: M = 512 along z; 509 prime: M = 1024
    along y; 127 prime on both)."""
    v = np.random.default_rng(sum(shape)).standard_normal(shape)
    plan = ck._zy_fft_plan(*shape[1:])
    assert plan.chirp_z or plan.chirp_y
    got = ck._zy_rfft_fft_plain(_t(v).float(), plan)
    assert got[0].dtype == torch.float32
    ref = np.fft.fft(np.fft.rfft(v, axis=2), axis=1)
    _close([g.double() for g in got], ref.real, ref.imag, 1e-6)


def test_mixed_radix_twin_in_float32_is_close():
    """The slab of path (c) at 512 x 512 x 480, cut to two x planes and 240
    rows: radices 15 x 16 along z, one rounding stage a pass."""
    v = np.random.default_rng(19).standard_normal((2, 240, 480))
    got = ck._zy_rfft_fft_plain(_t(v).float(), ck._zy_fft_plan(240, 480))
    assert got[0].dtype == torch.float32
    ref = np.fft.fft(np.fft.rfft(v, axis=2), axis=1)
    _close([g.double() for g in got], ref.real, ref.imag, 1e-6)


ROUTES = {
    (2, 2, 2): True, (3, 64, 32): True, (4, 512, 512): True, (2, 1024, 1024): True,
    (1, 1024, 2): True, (1, 1, 2): True, (3, 40, 50): True, (2, 64, 33): True, (1, 1, 1): True,
    (4, 512, 480): True, (2, 1, 7): True, (1, 2048, 2): False, (65536, 2, 2): False,
    (2, 22, 502): True, (1, 509, 8): True,
}


@pytest.mark.parametrize("shape", sorted(ROUTES))
def test_route_by_shape(shape):
    """Every shape within zy_rfft_fits (x 1..65535, y and z 1..1024) takes
    the FFT kernel: y and z with no prime factor above 7 by mixed radix,
    the others (a factor 11 in 33 and 22, 251 in 502, the prime 509) by
    Bluestein's algorithm, and nz = 1 with an empty z transform; the rest
    no kernel. The dense kernel is on no route."""
    assert ck._zy_uses_fft(shape) == ROUTES[shape] == ck.zy_rfft_fits(shape)
    if ROUTES[shape]:
        ck._zy_fft_plan(*shape[1:])


def test_cpu_wrappers_take_the_dense_twin():
    """On the CPU both routes' wrappers return the dense twin's result."""
    v = _t(np.random.default_rng(3).standard_normal((2, 16, 8)))
    ck.reset_launch_counts()
    for got in (ck.zy_rfft_planar(v), ck._zy_rfft_dense(v)):
        for g, r in zip(got, ck._zy_rfft_plain(v)):
            assert torch.equal(g, r)
    assert not any(ck.launch_counts().values())
