"""fava_tpu_torch's async ingest and series drivers held to fava_tpu and
to the port's per-snapshot analyses on the CPU, in float64.

Both packages read the same HDF5 files (written by the port's
synthetic writer). Tolerances: series against the port's own
per-snapshot analyses rtol 1e-12, atol 1e-13 of scale (the same code
on the same values, batched); against fava_tpu's series rtol 1e-10,
atol 1e-12 of the output's scale (float64 on both sides; FFT
implementation and summation order differ, as
tests/test_torch_flagship.py). Counts and times exact.
"""

import numpy as np
import pytest
import torch

import fava_tpu
import fava_tpu_torch
from fava_tpu_torch import flagship as tflag
from fava_tpu_torch.analysis import time_series
from fava_tpu_torch.io import flash_file, h5lite, ingest, synthetic

NAMES = ["dens", "velx", "vely", "velz"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def plt_dir(tmp_path):
    for i, t in enumerate([0.0, 0.1, 0.2, 0.3], start=1):
        synthetic.make_amr_file(
            tmp_path / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(4, 4, 4), nblks=(2, 2, 2),
            refine={0: 2}, time=t,
        )
    return tmp_path


@pytest.fixture()
def uni_dir(tmp_path):
    for i in (1, 2, 3):
        synthetic.make_uniform_file(
            tmp_path / f"rt_hdf5_uniform_000{i}", ncells=(16, 16, 16), seed=10 + i, time=0.1 * i
        )
    return tmp_path


def _close(got, ref, rtol, atol_scale):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_scale * scale)


# ---------------------------------------------------------------------------
# The prefetcher


def test_prefetcher_yields_all_snapshots_in_order(plt_dir):
    paths = sorted(plt_dir.glob("*plt_cnt*"))
    snaps = list(ingest.SnapshotPrefetcher(paths, ["dens", "velx"], depth=2, device="cpu"))
    assert [s.path for s in snaps] == paths
    np.testing.assert_array_equal([s.time for s in snaps], [0.0, 0.1, 0.2, 0.3])
    for s, p in zip(snaps, paths):
        assert set(s.fields) == {"dens", "velx"} and s.nbytes > 0
        with h5lite.File(p, "r") as f:
            ref = flash_file.read_field(f, "velx", "cpu", torch.float64)
        assert s.fields["velx"].ndim == 4 and torch.equal(s.fields["velx"], ref)


def test_prefetcher_missing_field_handling(plt_dir):
    paths = sorted(plt_dir.glob("*plt_cnt*"))[:1]
    with pytest.raises(KeyError, match="notafield"):
        list(ingest.SnapshotPrefetcher(paths, ["dens", "notafield"], device="cpu"))
    snaps = list(ingest.SnapshotPrefetcher(paths, ["dens", "notafield"], strict=False, device="cpu"))
    assert set(snaps[0].fields) == {"dens"}


def test_prefetcher_early_exit(uni_dir, monkeypatch):
    """Leaving the loop early cancels the window: not every snapshot is read."""
    reads = []
    real = ingest._read_snapshot

    def counting(path, *args, **kwargs):
        reads.append(path)
        return real(path, *args, **kwargs)

    monkeypatch.setattr(ingest, "_read_snapshot", counting)
    paths = sorted(uni_dir.glob("*uniform*")) * 4
    it = iter(ingest.SnapshotPrefetcher(paths, ["dens"], depth=2, device="cpu"))
    snap = next(it)
    assert snap.fields["dens"].shape[-3:] == (16, 16, 16)
    it.close()
    assert len(reads) <= 4 < len(paths)


def test_prefetcher_bf16_wire(uni_dir):
    paths = sorted(uni_dir.glob("*uniform*"))[:1]
    (full,) = ingest.SnapshotPrefetcher(paths, ["velx"], device="cpu")
    (wire,) = ingest.SnapshotPrefetcher(paths, ["velx"], wire_dtype=torch.bfloat16, device="cpu")
    assert wire.fields["velx"].dtype == torch.float64 and wire.nbytes * 2 == full.nbytes
    err = float((wire.fields["velx"] - full.fields["velx"]).abs().max())
    assert 0.0 < err <= 2 ** -8 * float(full.fields["velx"].abs().max())


def test_ingest_bandwidth_positive(plt_dir):
    paths = sorted(plt_dir.glob("*plt_cnt*"))
    assert ingest.ingest_bandwidth_gbps(paths, NAMES, device="cpu") > 0


# ---------------------------------------------------------------------------
# flagship_series


def test_flagship_series_matches_per_snapshot_and_fava_tpu(uni_dir):
    m = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    series = m.flagship_series(batch=2)  # batches of 2 + a final batch of 1
    np.testing.assert_array_equal(series["times"], [0.1 * i for i in (1, 2, 3)])
    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        for key, val in m.flagship_analysis().items():
            _close(series[key][j], val, 1e-12, 1e-13)
    ref = fava_tpu.FLASH(uni_dir).flagship_series(batch=2)
    assert sorted(ref) == sorted(series)
    for key, r in ref.items():
        if key in ("spectra_counts", "times"):
            np.testing.assert_array_equal(series[key], r)
        else:
            _close(series[key], r, 1e-10, 1e-12)


def test_flagship_series_auto_batch(uni_dir, monkeypatch):
    sizes = []
    real = tflag.series_analysis_step

    def spy(*stacked):
        sizes.append(stacked[0].shape[0])
        return real(*stacked)

    monkeypatch.setattr(tflag, "series_analysis_step", spy)
    fava_tpu_torch.FLASH(uni_dir, device="cpu").flagship_series()
    assert sizes == [3]  # 16^3 snapshots: the cap of 8, then the end of the series
    assert time_series.auto_batch(4 * 512**3 * 4, 7 / 16 * 80e9) == 8
    assert time_series.auto_batch(4 * 1024**3 * 4, 7 / 16 * 80e9) == 2
    assert time_series.auto_batch(4 * 512**3 * 4, 7e9) == 3  # fava_tpu's batch on 16 GB
    assert time_series.auto_batch(10**12, 7e9) == 1
    assert time_series.series_input_budget("cpu") == 7e9


def test_flagship_series_oom_halving(uni_dir, monkeypatch):
    """A batch that runs out of device memory halves and retries (the cap
    holds for the rest of the series), and the results still match the
    per-snapshot analysis; another error propagates."""
    m = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    real = tflag.series_analysis_step
    calls = []

    def flaky(*stacked):
        calls.append(stacked[0].shape[0])
        if stacked[0].shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(*stacked)

    monkeypatch.setattr(tflag, "series_analysis_step", flaky)
    series = m.flagship_series(batch=3)
    assert calls == [3, 2, 1, 1, 1]  # 3 fails, 2 fails, then singles
    for j in (0, 1, 2):
        m.load(file_type="uni", file_index=j)
        for key, val in m.flagship_analysis().items():
            _close(series[key][j], val, 1e-12, 1e-13)

    def broken(*stacked):
        raise RuntimeError("some other failure")

    monkeypatch.setattr(tflag, "series_analysis_step", broken)
    with pytest.raises(RuntimeError, match="some other failure"):
        m.flagship_series(batch=2)

    def always_oom(*stacked):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(tflag, "series_analysis_step", always_oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        m.flagship_series(batch=2)  # a single snapshot that does not fit raises


def test_flagship_series_rejects_multi_block_files(plt_dir):
    with pytest.raises(ValueError, match="single-block"):
        fava_tpu_torch.FLASH(plt_dir, device="cpu").flagship_series(file_type="plt")


@pytest.mark.parametrize("series", ["flagship_series", "reynolds_series", "favre_series"])
def test_series_unknown_file_type_named_error(uni_dir, series):
    m = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    with pytest.raises(ValueError, match="mesh-series.*'plt'"):
        getattr(m, series)(file_type="prt")


def test_series_take_file_indices(uni_dir):
    m = fava_tpu_torch.FLASH(uni_dir, device="cpu")
    out = m.flagship_series(file_indices=[2, 0])
    np.testing.assert_array_equal(out["times"], [0.1 * 3, 0.1 * 1])


# ---------------------------------------------------------------------------
# Reynolds and Favre series


def test_reynolds_series_matches_per_file_and_fava_tpu(plt_dir):
    m = fava_tpu_torch.FLASH(plt_dir, device="cpu")
    out = m.reynolds_series(file_type="plt", file_indices=[0, 1])
    assert out["Rxx"].shape[0] == 2
    m.load(file_index=1, file_type="plt")
    radius, stress, means = m.reynolds_stress(raxis=0)
    np.testing.assert_array_equal(out["radius"], radius)
    _close(out["Rxy"][1], stress["Rxy"], 1e-12, 1e-13)
    _close(out["mean_dens"][1], means["dens"], 1e-12, 1e-13)
    ref = fava_tpu.FLASH(plt_dir).reynolds_series(file_type="plt", file_indices=[0, 1])
    assert sorted(ref) == sorted(out)
    for key, r in ref.items():
        _close(out[key], r, 1e-10, 1e-12)


def test_favre_series_matches_per_file_and_fava_tpu(plt_dir):
    m = fava_tpu_torch.FLASH(plt_dir, device="cpu")
    out = m.favre_series(file_type="plt", file_indices=[0, 1])
    np.testing.assert_array_equal(out["times"], [0.0, 0.1])
    m.load(file_index=1, file_type="plt")
    single = m.favre_profiles(raxis=0)
    _close(out["favre_mean_velx"][1], single["favre_mean"]["velx"], 1e-12, 1e-13)
    _close(out["favre_rms_velz"][1], single["favre_rms"]["velz"], 1e-12, 1e-13)
    ref = fava_tpu.FLASH(plt_dir).favre_series(file_type="plt", file_indices=[0, 1])
    assert sorted(ref) == sorted(out)
    for key, r in ref.items():
        _close(out[key], r, 1e-10, 1e-12)
