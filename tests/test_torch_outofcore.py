"""fava_tpu_torch's out-of-core flagship step held to fava_tpu and to its
own in-core step on the CPU, in float64.

Inputs are made from a seed with numpy (or are the same HDF5 file) and
handed to both packages. fava_tpu runs its Pallas kernels in interpret
mode (pk.FORCE_INTERPRET), as its own tests do: its streamed step then
bins each kx chunk with ``_shell_kernel_chunkx`` (B6's Pallas kernel)
and takes its slab moments from K5/K6's. The port runs the plain twins
of its kernels (CPU tensors).

Tolerances:
- streamed vs in-core, and vs fava_tpu's streamed step: max |diff| over
  the output's scale (its largest magnitude) <= 1e-9; float64 on both
  sides, the transforms split differently ((y, z) then x against one
  3D transform; fava_tpu's dense DFT matmuls) and sums in other orders.
  fava_tpu's own streamed test uses the same bound. Counts exact.
- B6's plain twin vs fava_tpu's chunk binning: rtol 1e-10, atol 1e-12
  of the sums' scale (float64 sums of the same terms in another order,
  as tests/test_torch_kernels.py).
- bf16 wire: within 2e-2 of scale (bf16 keeps ~3 decimal digits) and
  not bit-equal.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu.io import flash_file as jflash_file
from fava_tpu.ops import outofcore as joc
from fava_tpu.ops import pallas_kernels as pk
from fava_tpu.ops import spectra as jspectra
from fava_tpu_torch import flagship as tflag
from fava_tpu_torch.io import flash_file, h5lite, synthetic
from fava_tpu_torch.mesh.flash_uniform import FlashUniform, streams_out_of_core
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import outofcore as toc
from fava_tpu_torch.ops import spectra as tspectra

NAMES = ("dens", "velx", "vely", "velz")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def force_interpret():
    pk.FORCE_INTERPRET = True
    yield
    pk.FORCE_INTERPRET = False


@pytest.fixture(scope="module", autouse=True)
def _leave_fava_tpu_chunk_kernels_as_found():
    """The interpret-mode streamed steps here fill fava_tpu's chunk-kernel
    builder cache (8 entries); empty it after the module, so that a later
    test file in the same worker that checks the builder runs
    (tests/test_parallel.py) does not find it full."""
    yield
    pk._build_shell_chunk_fn.cache_clear()


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    out = {"dens": 1.0 + 0.4 * rng.random(shape)}
    for a in "xyz":
        out[f"vel{a}"] = rng.standard_normal(shape)
    return out


def _loader(fields):
    def loader(name, x0, x1):
        return fields[name][x0:x1]

    return loader


def _close(got, ref, bound=1e-9):
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g, r = np.asarray(got[key], dtype=np.float64), np.asarray(r, dtype=np.float64)
        assert g.shape == r.shape, key
        assert np.isfinite(g).all(), key
        if key == "spectra_counts":
            np.testing.assert_array_equal(g, r, err_msg=key)
            continue
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= bound * scale, key


def _incore(fields):
    out = tflag.uniform_analysis_step(*(torch.tensor(fields[k]) for k in NAMES))
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The streamed step


# (shape, slab_rows, chunk_rows): the x Nyquist row nx/2 at the first row
# of a chunk (32 by 16, 24 by 4), in its middle (24 by 8) and at its last
# row (22 by 2); odd nx has none (15 by 5); a non-cubic volume.
CHUNKINGS = [
    ((32, 32, 32), 8, 16),
    ((24, 16, 16), 8, 4),
    ((24, 16, 16), 6, 8),
    ((22, 16, 16), 11, 2),
    ((15, 16, 16), 5, 5),
    ((16, 24, 20), 4, 8),
]


@pytest.mark.parametrize("shape,slab_rows,chunk_rows", CHUNKINGS)
def test_streamed_matches_the_incore_step(shape, slab_rows, chunk_rows):
    fields = _fields(shape, seed=sum(shape) + chunk_rows)
    got = toc.streamed_uniform_analysis(
        _loader(fields), shape, slab_rows=slab_rows, chunk_rows=chunk_rows, device="cpu"
    )
    _close(got, _incore(fields))


@pytest.mark.parametrize("shape,slab_rows,chunk_rows", [((32, 32, 32), 8, 16), ((15, 16, 16), 5, 5)])
def test_streamed_matches_fava_tpu(force_interpret, shape, slab_rows, chunk_rows):
    fields = _fields(shape, seed=21)
    ref = joc.streamed_uniform_analysis(
        _loader(fields), shape, slab_rows=slab_rows, chunk_rows=chunk_rows, dtype=jnp.float64
    )
    got = toc.streamed_uniform_analysis(
        _loader(fields), shape, slab_rows=slab_rows, chunk_rows=chunk_rows, device="cpu"
    )
    _close(got, ref)


def test_bf16_wire_approximates_the_incore_step():
    fields = _fields((16, 16, 16), seed=31)
    ref = _incore(fields)
    got = toc.streamed_uniform_analysis(
        _loader(fields), (16, 16, 16), slab_rows=4, chunk_rows=8, device="cpu",
        wire_dtype=torch.bfloat16,
    )
    for key in ("mean_dens", "reynolds_stress", "spectra_total"):
        scale = float(np.abs(ref[key]).max())
        err = float(np.abs(got[key] - ref[key]).max()) / scale
        assert 0.0 < err < 2e-2, (key, err)


def test_divisibility_is_checked():
    with pytest.raises(ValueError, match="must divide"):
        toc.streamed_uniform_analysis(_loader({}), (16, 16, 16), slab_rows=5, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        toc._check_divisible(16, 8, 3)


def test_chunk_powers_are_the_rows_of_the_whole_volume():
    """rfft_power_volumes on an x-chunk with its global jx/kx equals the
    chunk's rows of the whole-volume powers: the Nyquist split lands on
    the global row nx/2 only (here the first row of the third chunk)."""
    shape = (16, 12, 10)
    rng = np.random.default_rng(5)
    half = (3, 16, 12, 6)
    ffts = [torch.tensor(a) for a in rng.standard_normal(half) + 1j * rng.standard_normal(half)]
    whole = tspectra.rfft_power_volumes(ffts, shape)
    for kx0 in range(0, 16, 4):
        jx, kx = toc._chunk_wavenumbers(kx0, 4, 16, "cpu")
        part = tspectra.rfft_power_volumes([f[kx0 : kx0 + 4] for f in ffts], shape, jx=jx, kx=kx)
        for p, w in zip(part, whole):
            torch.testing.assert_close(p, w[kx0 : kx0 + 4], rtol=1e-14, atol=0)
        jref = jspectra.rfft_power_volumes(
            [jnp.asarray(f[kx0 : kx0 + 4].numpy()) for f in ffts], shape,
            jx=jnp.asarray(jx.numpy()), kx=jnp.asarray(kx.numpy(), dtype=jnp.float64),
        )
        np.testing.assert_allclose(part[1].numpy(), np.asarray(jref[1]), rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# B6: the chunk binning's plain twin


def _chunk_powers(shape, seed):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    half = (nx, ny, nz // 2 + 1)
    return np.abs(rng.standard_normal(half)), np.abs(rng.standard_normal(half))


@pytest.mark.parametrize("shape,rows", [((32, 16, 16), 8), ((24, 16, 20), 6), ((15, 8, 9), 5)])
@pytest.mark.parametrize("interpret", [True, False])
def test_chunk_binning_matches_fava_tpu(shape, rows, interpret):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    t, lo = _chunk_powers(shape, seed=nx + rows)
    pk.FORCE_INTERPRET = interpret
    try:
        for kx0 in range(0, nx, rows):
            jt, jl = jnp.asarray(t[kx0 : kx0 + rows]), jnp.asarray(lo[kx0 : kx0 + rows])
            jcounts, jsums = pk.shell_bin_sums_rfft_chunk(jt, jl, jt - jl, nbins, nx, nz, kx0)
            jvals = pk.shell_bin_values_rfft_chunk(jt, jl, nbins, nx, nz, kx0)
            tt, tl = torch.tensor(t[kx0 : kx0 + rows]), torch.tensor(lo[kx0 : kx0 + rows])
            counts, sums = ck.shell_bin_sums_rfft_chunk(tt, tl, nbins, nx, nz, kx0)
            vals = ck.shell_bin_values_rfft_chunk(tt, tl, nbins, nx, nz, kx0)
            np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
            for got, ref in ((sums, jsums), (vals, jvals)):
                ref = np.asarray(ref)
                scale = float(np.abs(ref).max())
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12 * scale)
    finally:
        pk.FORCE_INTERPRET = False


@pytest.mark.parametrize("shape,rows", [((32, 16, 16), 8), ((15, 9, 10), 3), ((16, 16, 16), 16)])
def test_chunks_sum_to_the_whole_volume(shape, rows):
    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    t, lo = (torch.tensor(a) for a in _chunk_powers(shape, seed=rows))
    whole = ck.shell_bin_sums_unfolded(t, lo, nbins, nz)
    acc = sum(
        ck.shell_bin_values_rfft_chunk(t[k : k + rows], lo[k : k + rows], nbins, nx, nz, k)
        for k in range(0, nx, rows)
    )
    torch.testing.assert_close(acc[:2], whole, rtol=1e-12, atol=1e-12 * float(whole.abs().max()))
    torch.testing.assert_close(acc[2], whole[0] - whole[1], rtol=1e-12, atol=1e-12 * float(whole.abs().max()))
    counts = sum(
        ck.shell_bin_sums_rfft_chunk(t[k : k + rows], lo[k : k + rows], nbins, nx, nz, k)[0]
        for k in range(0, nx, rows)
    )
    np.testing.assert_array_equal(counts.numpy(), ck.rfft_shell_counts(shape, nbins, device="cpu").numpy())
    np.testing.assert_array_equal(
        ck.rfft_shell_counts(shape, nbins, device="cpu").numpy(), pk.rfft_shell_counts(shape, nbins, "float64")
    )


def test_chunk_binning_rejects_bad_chunks():
    p = torch.ones(4, 8, 5)
    with pytest.raises(ValueError, match="z extent"):
        ck.shell_bin_values_rfft_chunk(p, p, 3, 8, 12, 0)
    with pytest.raises(ValueError, match="outside"):
        ck.shell_bin_values_rfft_chunk(p, p, 3, 8, 8, 6)
    with pytest.raises(ValueError, match="same-shaped"):
        ck.shell_bin_values_rfft_chunk(p, p[:2], 3, 8, 8, 0)


# ---------------------------------------------------------------------------
# The slab stream


def test_slab_stream_order_and_prefetch():
    """Slabs arrive in x order whatever the worker timing."""
    calls = []

    def loader(name, x0, x1):
        if x0 == 0:
            time.sleep(0.05)  # the first slab slowest: later ones finish first
        calls.append((name, x0))
        return np.full((x1 - x0, 4, 4), float(x0))

    seen = []
    for x0, (slab,) in toc._slab_stream(loader, ("dens",), 16, 4, "cpu", depth=3):
        seen.append(x0)
        assert slab.dtype == torch.float64 and slab.shape == (4, 4, 4)
        assert torch.equal(slab, torch.full((4, 4, 4), float(x0), dtype=torch.float64))
    assert seen == [0, 4, 8, 12]
    assert {c[1] for c in calls} == {0, 4, 8, 12}


def test_slab_stream_depth_clamped_and_early_exit():
    """depth <= 0 clamps to 1, each slab loads exactly once, and closing
    the stream early cancels its window."""
    calls = []

    def loader(name, x0, x1):
        calls.append(x0)
        return np.zeros((x1 - x0, 4, 4), np.float32)

    for depth in (0, -1, 1, 3):
        calls.clear()
        out = list(toc._slab_stream(loader, ("dens",), 8, 4, "cpu", depth=depth))
        assert [x0 for x0, _ in out] == [0, 4], depth
        assert sorted(calls) == [0, 4], depth

    calls.clear()
    gen = toc._slab_stream(loader, ("dens",), 64, 4, "cpu", depth=2)
    next(gen)
    gen.close()
    time.sleep(0.05)
    assert len(calls) <= 4  # the first slab, the window and at most one more


def test_slab_stream_swaps_stored_layouts():
    """A loader may hand back a permuted view of the stored (z, y, x)
    layout, as read_field_slab does: the slab arrives in grid order."""
    rng = np.random.default_rng(2)
    stored = rng.standard_normal((6, 5, 8)).astype(np.float32)  # (nz, ny, nx)

    def loader(name, x0, x1):
        return np.swapaxes(stored[:, :, x0:x1].copy(), 0, 2)

    slabs = [s for _, (s,) in toc._slab_stream(loader, ("dens",), 8, 4, "cpu")]
    np.testing.assert_array_equal(torch.cat(slabs).numpy(), np.swapaxes(stored, 0, 2))


# ---------------------------------------------------------------------------
# The file and the entry point


@pytest.fixture()
def uni_dir(tmp_path):
    synthetic.make_uniform_file(tmp_path / "rt_hdf5_uniform_0001", ncells=(16, 16, 16), seed=9)
    return tmp_path


def test_read_field_slab_matches_fava_tpu(uni_dir):
    import h5py

    path = uni_dir / "rt_hdf5_uniform_0001"
    with h5lite.File(path, "r") as f, h5py.File(path, "r") as g:
        for x0, x1 in ((0, 4), (5, 16), (3, 4)):
            got = flash_file.read_field_slab(f, "velx", x0, x1)
            ref = jflash_file.read_field_slab(g, "velx", x0, x1, dtype=np.float32)
            assert got.shape == (x1 - x0, 16, 16)
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(f["dens"][..., 2:7], g["dens"][..., 2:7])
        np.testing.assert_array_equal(f["dens"][0, 3], g["dens"][0, 3])
        with pytest.raises(KeyError, match="bogus"):
            flash_file.read_field_slab(f, "bogus", 0, 4)


def test_read_field_slab_rejects_multi_block_data(tmp_path):
    path = tmp_path / "rt_hdf5_plt_cnt_0001"
    synthetic.make_amr_file(path, ncells=(4, 4, 4), nblks=(2, 1, 1))
    with h5lite.File(path, "r") as f, pytest.raises(ValueError, match="single-block"):
        flash_file.read_field_slab(f, "dens", 0, 2)


def test_mesh_streamed_matches_incore_and_fava_tpu(uni_dir):
    tm = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    tm.load(file_type="uni")
    incore = tm.flagship_analysis(streamed=False)
    streamed = tm.flagship_analysis(streamed=True, slab_rows=4, chunk_rows=8)
    _close(streamed, incore)
    jm = fava_tpu.FLASH(uni_dir)
    jm.load(file_type="uni")
    _close(streamed, jm.flagship_analysis(streamed=True, slab_rows=4, chunk_rows=8))
    _close(tm.flagship_analysis(), jm.flagship_analysis(streamed=False))


def test_stream_knobs_need_streamed_true(uni_dir):
    tm = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    tm.load(file_type="uni")
    for knobs in ({"slab_rows": 4}, {"chunk_rows": 8}, {"wire_dtype": torch.bfloat16},
                  {"prefetch_depth": 3}):
        with pytest.raises(TypeError, match="streamed=True"):
            tm.flagship_analysis(streamed=False, **knobs)
    tm.flagship_analysis(slab_rows=4)  # streamed=None: the knobs are legitimate


def test_from_arrays_mesh_cannot_stream():
    m = fava_tpu_torch.from_arrays(_fields((8, 8, 8), seed=1), device="cpu")
    with pytest.raises(ValueError, match="file-backed"):
        m.flagship_analysis(streamed=True)


def test_knobs_round_down_to_divisors(uni_dir, monkeypatch):
    assert FlashUniform._largest_divisor(24, 7) == 6
    assert FlashUniform._largest_divisor(24, None) == 24
    assert FlashUniform._largest_divisor(96, None) == 48
    assert FlashUniform._largest_divisor(15, 100) == 15
    assert FlashUniform._largest_divisor(13, 5) == 1
    seen = {}

    def spy(loader, shape, **kw):
        seen.update(kw)
        return {}

    monkeypatch.setattr(toc, "streamed_uniform_analysis", spy)
    tm = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    tm.load(file_type="uni")
    tm.flagship_analysis(streamed=True, slab_rows=5, chunk_rows=7)
    assert (seen["slab_rows"], seen["chunk_rows"]) == (4, 4)


@pytest.mark.parametrize(
    "n,free_gb,resident_gb,streams",
    [(1024, 80, 0, False), (1280, 80, 0, True), (1152, 80, 0, True), (512, 16, 0, False),
     (1024, 64, 0, True), (1024, 64, 17.2, False), (1024, 16, 0, True)],
)
def test_auto_dispatch_decision(n, free_gb, resident_gb, streams):
    """The in-core rule: 4 fields, 3 half-spectra and the working set
    (~60 GB at 1024^3 f32, ~118 GB at 1280^3) against 90% of free memory,
    less the fields already resident."""
    got = streams_out_of_core((n, n, n), torch.float32, free_gb * 1e9, int(resident_gb * 1e9))
    assert got is streams


def test_auto_dispatch_runs_in_core_on_the_cpu(uni_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(toc, "streamed_uniform_analysis", lambda *a, **k: calls.append(1))
    tm = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    tm.load(file_type="uni")
    out = tm.flagship_analysis()
    assert not calls and "spectra_total" in out
