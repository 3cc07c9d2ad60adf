#!/usr/bin/env python3
"""Smoke run of the fava_tpu_torch flagship path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints
no result):

1. device: CUDA present; card name and power limit (nvidia-smi), CUDA,
   nvcc and triton versions.
2. build: compile fava_tpu_torch/csrc/*.cu for sm_90a and load it.
3. kernels: each of the four kernels against its plain PyTorch version
   at the 512^3 shapes of the flagship path (float32 in; the plain
   version gets the same values in float64), with stated tolerances.
4. main path: ``from_arrays(make_example_fields(512)).flagship_analysis()``
   with every launch counter reset before and checked after; outputs
   finite, counts equal to the static counts, and within a stated bound
   of the plain float64 path on the CPU. Then ``series_analysis_step``
   on 4 snapshots of 512^3.
5. timings: warm per-snapshot wall of the single step and of the batch
   of 4 (host clock around synchronized work), a per-stage breakdown and
   each kernel against its plain version (CUDA events).

The last two lines are one JSON object with a row per kernel, then
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 512
NSNAP = 4
NAMES = ("dens", "velx", "vely", "velz")
SOURCE = "fava_tpu_torch/csrc/flagship_kernels.cu"
REPLACES = {
    "row_moments": "fava_tpu/ops/pallas_kernels.py:95",
    "centered_row_moments": "fava_tpu/ops/pallas_kernels.py:200",
    "fold_quadrants_pair": "fava_tpu/ops/pallas_kernels.py:678",
    "shell_bin_values_folded": "fava_tpu/ops/pallas_kernels.py:955",
}
# Kernel vs plain float64 version on the same values (see phase_kernels).
TOL_MOMENTS = 1e-10  # of the sum of |terms|: f64 sums of 2.6e5 terms, n*eps ~ 3e-11
TOL_FOLD = 2e-7  # relative: <= 3 float32 roundings of a sum of <= 4 positive terms
TOL_BIN = 1e-9  # relative per shell: f64 sums of <= ~1e6 positive terms in another order
# Main path (float32 fields, float64 sums) vs the plain float64 path on the
# CPU, as max |diff| / scale per output (see phase_main): the spectra carry
# float32 FFT and power rounding; the profiles only summation order.
TOL_SPECTRA = 1e-5
TOL_PROFILES = 1e-9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: device


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    from fava_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    release = [ln for ln in ver.stdout.splitlines() if "release" in ln]
    try:
        import triton

        triton_state = f"imports ({triton.__version__})"
    except ImportError:
        triton_state = "does not import"
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__}; torch.version.cuda {torch.version.cuda}; "
        f"nvcc {nvcc}: {release[0].strip() if release else ver.stdout.strip()}; triton {triton_state}")
    return card


# ---------------------------------------------------------------------------
# Phase 2: build


def phase_build():
    from fava_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    say(f"phase 2 build: {lib_path.relative_to(HERE)} in {secs:.3f} s")
    for line in (_build.BUILD_LOG or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"  ptxas: {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions at the path's shapes


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def path_powers(torch, fields):
    from fava_tpu_torch.ops.spectra import rfft_power_volumes

    dens, *vels = fields
    sq = torch.sqrt(dens)
    ffts = [torch.fft.rfftn(sq * v, norm="forward") for v in vels]
    return rfft_power_volumes(ffts, tuple(dens.shape))


def phase_kernels(torch, fields):
    from fava_tpu_torch.ops import cuda_kernels as ck

    nx, ny, nz = fields[0].shape
    layer = float(ny * nz)
    nbins = max(nx, ny, nz) // 2 - 1
    f64 = [f.double() for f in fields]
    rows = {}

    def record(name, got, ref, bound, err_ratio, kernel_fn, plain_fn):
        max_abs = float((got.double() - ref).abs().max())
        say(f"phase 3 {name}: max_abs_err {max_abs!r}, error/bound {err_ratio!r} "
            f"(bound {bound!r}), shapes {tuple(got.shape)}")
        if not err_ratio <= 1.0:
            fail(f"{name} disagrees with its plain version (error/bound {err_ratio!r})")
        rows[name] = {
            "max_abs_err": max_abs,
            "ms": cuda_ms(torch, kernel_fn, 20),
            "plain_ms": cuda_ms(torch, plain_fn, 5),
        }

    # K1: |got - ref| against the sum of |terms| (plain moments of |fields|).
    got = ck.row_moments_volume(*fields)
    torch.cuda.synchronize()
    ref = ck._row_moments_plain(*f64)
    mag = ck._row_moments_plain(*(f.abs() for f in f64))
    record("row_moments", got, ref, TOL_MOMENTS,
           float(((got - ref).abs() / (TOL_MOMENTS * mag)).max()),
           lambda: ck.row_moments_volume(*fields), lambda: ck._row_moments_plain(*fields))

    # K2, on the float64 row means of the path.
    means = (ref[1:4] / layer).contiguous()
    got = ck.centered_row_moments(*fields, means)
    torch.cuda.synchronize()
    ref = ck._centered_plain(*f64, means)
    cabs = [(v - m[:, None, None]).abs() for v, m in zip(f64[1:], means)]
    amom = ck._row_moments_plain(f64[0], *cabs)
    del cabs
    mag = torch.cat([amom[7:13], amom[4:7]])
    record("centered_row_moments", got, ref, TOL_MOMENTS,
           float(((got - ref).abs() / (TOL_MOMENTS * mag)).max()),
           lambda: ck.centered_row_moments(*fields, means),
           lambda: ck._centered_plain(*fields, means))
    del f64, amom, mag

    # K3 on the path's power volumes.
    total, longi = path_powers(torch, fields)
    folded = ck.fold_quadrants_pair(total, longi)
    torch.cuda.synchronize()
    ratio = 0.0
    for g, p in zip(folded, (total, longi)):
        r = ck._fold_plain(p.double())
        ratio = max(ratio, float(((g.double() - r).abs() / (TOL_FOLD * r).clamp(min=1e-300)).max()))
    record("fold_quadrants_pair", folded[0], ck._fold_plain(total.double()), TOL_FOLD, ratio,
           lambda: ck.fold_quadrants_pair(total, longi),
           lambda: (ck._fold_plain(total), ck._fold_plain(longi)))
    del total, longi

    # K4 on the folded volumes; run twice to show the atomics' spread.
    got = ck.shell_bin_values_folded(*folded, nbins, ny, nz)
    again = ck.shell_bin_values_folded(*folded, nbins, ny, nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_folded_plain(*(a.double() for a in folded), nbins, ny, nz)
    say(f"phase 3 shell_bin_values_folded: run-to-run max |diff| {float((got - again).abs().max())!r}")
    record("shell_bin_values_folded", got, ref, TOL_BIN,
           float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max()),
           lambda: ck.shell_bin_values_folded(*folded, nbins, ny, nz),
           lambda: ck._shell_bin_folded_plain(*folded, nbins, ny, nz))
    del folded
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path


def check_outputs(np, out, shape, where):
    from fava_tpu_torch.ops import cuda_kernels as ck

    nx, ny, nz = shape
    nbins = max(shape) // 2 - 1
    expect = {
        "spectra_counts": (nbins,), "spectra_total": (nbins,), "spectra_longitudinal": (nbins,),
        "spectra_transverse": (nbins,), "mean_dens": (nx,), "reynolds_stress": (6, nx),
        "favre_mean": (3, nx), "favre_rms": (3, nx), "total_mass": (),
    }
    lead = () if where == "single" else (out["spectra_total"].shape[0],)
    for key, shp in expect.items():
        v = np.asarray(out[key])
        if v.shape != lead + shp:
            fail(f"{where}: {key} has shape {v.shape}, expected {lead + shp}")
        if not np.isfinite(v).all():
            fail(f"{where}: {key} is not finite")
    counts = ck._folded_counts((nx // 2 + 1, ny // 2 + 1, nz // 2 + 1), nbins, nx, ny, nz)
    if not (np.asarray(out["spectra_counts"]) == counts).all():
        fail(f"{where}: spectra_counts differ from the static counts")


def phase_main(torch, np, fields):
    import fava_tpu_torch
    from fava_tpu_torch import flagship
    from fava_tpu_torch.ops import cuda_kernels as ck

    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)))
    ck.reset_launch_counts()
    out = model.flagship_analysis()
    launches = ck.launch_counts()
    say(f"phase 4 flagship_analysis launches: {launches}")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the path was never launched: {launches}")
    check_outputs(np, out, (N, N, N), "single")

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref = flagship.uniform_analysis_step(*(f.double().cpu() for f in fields))
    say(f"phase 4 plain float64 path on the CPU: {time.perf_counter() - t0:.1f} s")
    # Scale of each output: its largest magnitude, floored by the field
    # scale for outputs that can vanish up to rounding (the trig fields'
    # row means of v are ~0), as fava_tpu's float32 step test normalizes.
    vmax = max(float(v.abs().max()) for v in fields[1:])
    floor = {"favre_mean": vmax, "favre_rms": vmax,
             "reynolds_stress": float(fields[0].abs().max()) * vmax**2}
    errs = {}
    for key, r in ref.items():
        r = r.numpy()
        scale = max(float(np.abs(r).max()), floor.get(key, 0.0))
        errs[key] = float(np.abs(out[key] - r).max() / scale)
        bound = TOL_SPECTRA if key.startswith("spectra_") else TOL_PROFILES
        say(f"phase 4 {key}: max|diff|/scale {errs[key]!r} (bound {bound!r})")
        if not errs[key] <= bound:
            fail(f"{key} disagrees with the plain float64 path")
    del ref

    batch = flagship.make_example_field_batch(NSNAP, N)
    ck.reset_launch_counts()
    series = flagship.series_analysis_step(*batch)
    torch.cuda.synchronize()
    s_launch = ck.launch_counts()
    say(f"phase 4 series_analysis_step x{NSNAP} launches: {s_launch}")
    if any(v != NSNAP for v in s_launch.values()):
        fail(f"series run launched {s_launch}, expected {NSNAP} each")
    series = {k: v.cpu().numpy() for k, v in series.items()}
    check_outputs(np, series, (N, N, N), "series")
    # Snapshot 0 is the single step's input: equal up to the binning atomics.
    for key, v in out.items():
        d = float(np.abs(series[key][0] - v).max() / max(np.abs(v).max(), floor.get(key, 0.0)))
        if not d <= TOL_BIN:
            fail(f"series snapshot 0 {key} differs from the single step by {d!r}")
    say("phase 4 series snapshot 0 equals the single step (within the binning tolerance)")
    return launches, errs, model, batch


# ---------------------------------------------------------------------------
# Phase 5: timings


def wall_per_call(torch, fn, reps: int):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def stage_ms(torch, fields):
    """One step's device time per stage (CUDA events between stages)."""
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops.profiles import assemble_profile_stats
    from fava_tpu_torch.ops.spectra import rfft_power_volumes

    dens, vx, vy, vz = fields
    nx, ny, nz = dens.shape
    nbins = max(nx, ny, nz) // 2 - 1
    layer = float(ny * nz)
    names = ("fft", "powers", "fold", "binning", "moments", "centered", "assembly")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    ev[0].record()
    sq = torch.sqrt(dens)
    ffts = [torch.fft.rfftn(sq * v, norm="forward") for v in (vx, vy, vz)]
    del sq
    ev[1].record()
    total, longi = rfft_power_volumes(ffts, (nx, ny, nz))
    del ffts
    ev[2].record()
    folded = ck.fold_quadrants_pair(total, longi)
    ev[3].record()
    ck.shell_bin_values_folded(*folded, nbins, ny, nz)
    ev[4].record()
    mom = ck.row_moments_volume(dens, vx, vy, vz)
    ev[5].record()
    means = (mom[1:4] / layer).contiguous()
    cen = ck.centered_row_moments(dens, vx, vy, vz, means)
    ev[6].record()
    assemble_profile_stats(mom[0], means, cen[6:9], cen[:6], layer)
    ev[7].record()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def phase_timings(torch, fields, model, batch, card):
    from fava_tpu_torch import flagship

    single = wall_per_call(torch, lambda: flagship.uniform_analysis_step(*fields), 5)
    entry = wall_per_call(torch, model.flagship_analysis, 3)
    torch.cuda.reset_peak_memory_stats()
    series = [t / NSNAP for t in wall_per_call(torch, lambda: flagship.series_analysis_step(*batch), 3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage_ms(torch, fields)
    stages = stage_ms(torch, fields)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    timings = {
        "card": card,
        "uniform_analysis_step_s": single,
        "uniform_analysis_step_median_s": statistics.median(single),
        "flagship_analysis_s": entry,
        "series_batch4_per_snapshot_s": series,
        "series_batch4_per_snapshot_median_s": statistics.median(series),
        "series_peak_allocated_GiB": peak,
        "stage_ms": stages,
        "nvidia_smi_after": smi.stdout.strip(),
    }
    say(f"phase 5 timings: {json.dumps(timings)}")


def main() -> None:
    sys.path.insert(0, str(HERE))
    try:
        import numpy as np
        import torch

        import fava_tpu_torch
    except ImportError as e:
        fail(f"cannot import the port from {HERE}: {e}")
    if Path(fava_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"fava_tpu_torch was imported from {fava_tpu_torch.__file__}, not this checkout")

    card = phase_device(torch)
    build_s = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fava_tpu_torch import flagship

    fields = flagship.make_example_fields(N)
    rows = phase_kernels(torch, fields)
    launches, _errs, model, batch = phase_main(torch, np, fields)
    phase_timings(torch, fields, model, batch, card)

    if any(m.split(".")[0] in ("jax", "fava_tpu") for m in sys.modules):
        fail("JAX or fava_tpu was imported")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in REPLACES
    ]
    say(f"build seconds {build_s!r}; {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
