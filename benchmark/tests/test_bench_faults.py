"""The harness's run with the timed path broken underneath comes out not
correct, once for each fault the cells can have, and the control (the
reference in bfloat16 put in the program's place) fails the limits. The
look for a card is skipped: the run is on the CPU at a small size."""

import time

import numpy as np
import pytest
import torch

from fava_tpu_torch import flagship
from fava_tpu_torch.ops import cuda_kernels
from harness import entries, runner, spec

SHAPE = (16, 16, 16)
CELLS = ("rtflame512.series8", "turb1024.flagship")


def _run(workload, seed=11):
    return runner.run(workload, seed, 0.05, False, time.perf_counter(), device="cpu", shape=SHAPE)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


def test_half_the_batch_left_out(monkeypatch):
    """The series step computes the first half of the batch and fills the
    rest with it (its mean taken over the half it kept)."""
    real = flagship.series_analysis_step

    def half(dens, velx, vely, velz):
        k = dens.shape[0] // 2
        out = real(dens[:k], velx[:k], vely[:k], velz[:k])
        return {key: torch.cat([v, v[-1:].expand((dens.shape[0] - k,) + v.shape[1:])]) for key, v in out.items()}

    monkeypatch.setattr(flagship, "series_analysis_step", half)
    r = _run("rtflame512.series8")
    assert r["correct"] is False and r["failed"] == r["attempted"]


def _altered(fn, which):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        t = out[which] if which is not None else out
        t.view(-1)[5] *= 1.05  # row 0 (sums of rho; xx covariance; total power), x or shell 5
        return out
    return wrapped


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["moments", "centered", "spectrum", "counts", "state_unchanged",
                                   "inputs_modified"])
def test_fault_is_caught(monkeypatch, workload, fault):
    if fault == "moments":  # an answer altered where it is produced: K1's output
        monkeypatch.setattr(cuda_kernels, "row_moments_volume",
                            _altered(cuda_kernels.row_moments_volume, None))
    elif fault == "centered":  # K2's output
        monkeypatch.setattr(cuda_kernels, "centered_row_moments",
                            _altered(cuda_kernels.centered_row_moments, None))
    elif fault == "spectrum":  # one shell sum of the binning
        monkeypatch.setattr(cuda_kernels, "shell_bin_sums_rfft",
                            _altered(cuda_kernels.shell_bin_sums_rfft, 1))
    elif fault == "counts":  # one shell's count off by one
        real = cuda_kernels._static_counts

        def counts(*a, **k):
            c = real(*a, **k).clone()
            c[3] += 1
            return c
        monkeypatch.setattr(cuda_kernels, "_static_counts", counts)
    elif fault == "state_unchanged":  # the binning returns its accumulators untouched
        real = cuda_kernels.shell_bin_sums_rfft

        def zeros(*a, **k):
            c, s = real(*a, **k)
            return c, torch.zeros_like(s)
        monkeypatch.setattr(cuda_kernels, "shell_bin_sums_rfft", zeros)
    elif fault == "inputs_modified":  # the step overwrites its inputs
        real = cuda_kernels.row_moments_volume

        def clobber(dens, vx, vy, vz):
            out = real(dens, vx, vy, vz)
            dens.mul_(1.0 + 1e-3)
            return out
        monkeypatch.setattr(cuda_kernels, "row_moments_volume", clobber)
    r = _run(workload)
    assert r["correct"] is False


def _shells(change):
    """The binning's shell sums [total, longitudinal, transverse] changed
    in place by ``change(sums, nbins)``."""
    real = cuda_kernels.shell_bin_sums_rfft

    def wrapped(total, longi, nbins, full_nz):
        c, s = real(total, longi, nbins, full_nz)
        change(s, int(nbins))
        return c, s
    return wrapped


def _high_shell(s, nbins):
    s[:, nbins - 10] *= 1.001


def _upper_half_zeroed(s, nbins):
    s[:, nbins // 2 + 1:] = 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("change", [_high_shell, _upper_half_zeroed], ids=["high_shell", "upper_half_zeroed"])
def test_high_shell_faults_are_caught(monkeypatch, workload, change):
    """Shells far down the spectrum, which hold a small share of the
    largest shell's power: one high shell 0.1% off, or every shell above
    nbins/2 left at zero. Each shell is judged against its own power."""
    monkeypatch.setattr(cuda_kernels, "shell_bin_sums_rfft", _shells(change))
    r = runner.run(workload, 11, 0.05, False, time.perf_counter(), device="cpu", shape=(64, 64, 64))
    assert r["correct"] is False
    over = [k for k, (v, lim) in r["checks"].items() if v == "inf" or v > lim]
    assert "spectra_total" in over and "spectra_longitudinal" in over


@pytest.mark.parametrize("workload", CELLS)
def test_zeroed_upper_shells_fail_at_the_cells_size(workload):
    """At 1024^3 a k^-2 spectrum's shells above k = 255 hold under 2e-5
    of the largest shell's power: with the spectra's upper half zeroed
    (or one high shell 1% off) the comparison still reads each shell
    against its own power and fails the cell's limits."""
    from harness import compare

    ref_mod = spec.load_module("reference", "flagship")
    nbins = 510
    k = np.arange(nbins, dtype=np.float64)
    total = np.where(k > 0, np.maximum(k, 1.0) ** -2.0, 1e-3)
    ref = {"spectra_counts": np.ones(nbins), "spectra_total": total,
           "spectra_longitudinal": total / 3, "spectra_transverse": 2 * total / 3,
           "favre_mean": np.zeros((3, 4))}
    fields = {n: torch.ones((4, 4, 4), dtype=torch.float64) for n in ref_mod.NAMES}
    scales = ref_mod.scales(ref, fields)
    limits = spec.load_cell(workload).limits
    zeroed = {key: v.copy() for key, v in ref.items()}
    for key in ref_mod.SPECTRA:
        zeroed[key][nbins // 2 + 1:] = 0
    one_off = {key: v.copy() for key, v in ref.items()}
    for key in ref_mod.SPECTRA:
        one_off[key][nbins - 10] *= 1.01
    for got in (zeroed, one_off):
        numbers = compare.snapshot_numbers(got, ref, scales, ref_mod.EXACT)
        assert all(numbers[key] > limits[key] for key in ref_mod.SPECTRA), numbers


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(monkeypatch, workload):
    """The reference computed with bfloat16 inputs, products and
    transforms (float32 accumulation), put in the program's place."""
    ref = spec.load_module("reference", "flagship")

    def control(self):
        n = self.batch
        return [{k: np.asarray(v) for k, v in
                 ref.outputs(entries.snapshot(self._inputs, i), dtype=torch.float32,
                             store=torch.bfloat16).items()} for i in range(n)]

    monkeypatch.setattr(entries.Entry, "request", control)
    r = _run(workload)
    assert r["correct"] is False
    over = [k for k, (v, lim) in r["checks"].items() if v == "inf" or v > lim]
    assert over
