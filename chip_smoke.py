#!/usr/bin/env python3
"""Smoke run of the fava_tpu_torch flagship, AMR, stage-4, streaming and
fused-spectrum paths, its velocity, filtering and two-point analyses, its
pipeline CLI, its particle analyses, its sharded paths, its AMR paths over
devices and its pod series on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and prints
no result):

1. device: CUDA present; card name and power limit (nvidia-smi), CUDA,
   nvcc, triton and scipy versions (scipy must import: stage 1 fits with
   it).
2. build: compile fava_tpu_torch/csrc/*.cu for sm_90a (one nvcc a
   source, all at once; each source's compile seconds printed) and load
   it.
3. kernels: each of the four kernels against its plain PyTorch version
   at the 512^3 shapes of the flagship path (float32 in; the plain
   version gets the same values in float64), with stated tolerances;
   K4's ptxas report and launch, and its time through its C entry beside
   its wrapper's, each against its bound (as phases 11, 12, 13 and 18 do
   for B4, B10, B6, B9, B11a and B11b).
4. main path: ``from_arrays(make_example_fields(512)).flagship_analysis()``
   with every launch counter reset before and checked after; outputs
   finite, counts equal to the static counts, and within a stated bound
   of the plain float64 path on the CPU. Then ``series_analysis_step``
   on 4 snapshots of 512^3.
5. timings: warm per-snapshot wall of the single step and of the batch
   of 4 (host clock around synchronized work), a per-stage breakdown and
   each kernel against its plain version (CUDA events).
6. AMR file: ``io.synthetic.make_amr_file`` writes an rtflame-like plt
   file in a temporary directory: 16^3-cell blocks on a 4x1x1 root grid
   over [0,4]x[0,1]x[0,1], refined by x position to level 6 around the
   flame (a wrinkled front at x = 2 in ``flam``; 39,076 blocks, 34,192
   leaves, finest grid 2048x512x512, 0.64 GB
   per float32 field); ``FLASH(d).load(file_type="plt")`` and the four
   velocity/density fields read onto the card, timed per field.
7. AMR kernels: K5/K6 on the leaf stack and K7 on the full-domain regrid
   (2048x512x512, scales 1-16) against their plain versions; K7's ptxas
   report, launch and occupancy.
8. AMR path, each step with the launch counters reset before and checked
   after: ``reynolds_stress`` and ``favre_profiles`` (K5, K6);
   ``mesh.from_amr`` of the window [1.5,2.5]x[0,1]x[0,1] to 512^3 with
   the uniform file written (K7), the window equal to the plain regrid;
   the file read back as ``uni`` and equal to the regridded tensors;
   its ``flagship_analysis`` (K1, K2, B9), finite with the static counts. The
   profiles are then held to the plain float64 path on the CPU.
9. AMR timings: file synthesis and write, HDF5->card per field, the
   leaf gather, K5, K6, scatter and assembly, K7, the uniform write and
   read-back and the window's flagship step.
10. Stage 4 on the AMR leaves (phase 8, before ``from_amr`` collapses
   the mesh): the pdf2d kernel's ptxas report, launch and occupancy; the
   kernel with cell-volume weights (pdf2d_weighted) against its plain
   version on the 140 M leaf samples, and unweighted (pdf2d_counts) on the
   same samples, timed against its bound; then ``pdf2d``
   (volume-weighted and unweighted), ``pdf1d``, ``density_pdf``,
   ``binned_statistic``, ``mass_sum`` and ``volume_average`` with the
   counters reset before and checked after each, held to the plain
   float64 path on the CPU at the end of phase 8.
11. Stage 4 on the 512^3 window read back from its file: pdf2d_counts on
   (dens, velx) and the single-channel K4 on the folded dens power
   against their plain versions; pdf2d_weighted on the window with mass
   weights, and both pdf2d kernels on 134 M uncorrelated uniform samples,
   each held to its plain version and timed against its bound;
   ``kinetic_energy_spectra``,
   ``scalar_spectra("dens")``, ``pdf1d``, ``pdf2d`` (unweighted and
   mass-weighted), ``density_pdf``, ``binned_statistic``, ``mass_sum``
   and ``mass_fraction`` with counters; every result written to an
   analysis file with ``save_to_hdf5`` and read back equal; each held to
   the plain float64 path on the CPU; warm walls.
12. Odd extents: the window cut to 511x512x512 through ``from_arrays``:
   the unfolded binning kernel (B10) against its plain version (its
   ptxas report, launch and occupancy printed), then
   ``kinetic_energy_spectra``, ``scalar_spectra`` and
   ``flagship_analysis`` through it, with counters, held to the plain
   float64 path on the CPU.
13. Chunk binning (B6): ``make_example_fields(1024)`` on the card (and a
   host copy for phase 14), the in-core step as phase 14's reference,
   then the kernel against its plain version on the path's (128, 1024,
   513) chunks at kx0 = 0, 448 and 896 and on a chunk of an odd-nx
   (1023) volume; the 8 chunks of a snapshot add up to B10 on the whole
   volume, and their time against their bound; B6's launch and
   occupancy; phase 18's spectra paths (a) and (m) on these fields, timed.
14. Streamed step at 1024^3: ``ops.outofcore.streamed_uniform_analysis``
   from the host copy through a host-memory slab loader, twice, each run
   with counters (B6 per chunk, K5/K6 per slab) and held to the in-core
   step on the card; stage walls and peak memory. Then the streamed
   velocity correlations and two-point lines of dens from the same host
   copy, held to the in-core analyses on the card (two-point's K3 + B4
   counted), with walls and peak memory.
15. Beyond in-core: 1280^3 fields on the host, the auto-dispatch rule
   (``mesh.flash_uniform.streams_out_of_core``) against the card's free
   memory, the streamed step with counters; outputs finite with the
   static counts, total_mass and mean_dens held to float64 host sums of
   dens; stage walls, peak card memory and host RSS. Then the four
   streamed statistics drivers on the same host arrays (the summary
   without Mach statistics, gradients, correlations, lines of dens), each
   with its wall and peak card memory, held to plain float64 sums of the
   host arrays (slab by slab on the card): the summary's real-space
   entries, the variance of dens, the zero mean of every du_i/dx_j on the
   periodic box.
16. Entry point: the 512^3 window file's x-slab read rate, then
   ``FLASH(d).load("uni").flagship_analysis(streamed=True, slab_rows=64,
   chunk_rows=128)`` and ``flagship_analysis()`` (in core: K1, K2, B9, no
   B6), held to each other and to the float64 CPU path of phase 11.
17. Series: three more 512^3 uniform files from ``make_example_fields``;
   ``flagship_series`` with the auto batch and with batch 3, each
   snapshot held to ``flagship_analysis`` on its file; the ingest rate;
   ``reynolds_series``/``favre_series`` over the plt catalog held to the
   mesh's ``reynolds_stress``/``favre_profiles``.
18. Fused-spectrum path (run after phase 5, on phase 3's 512^3 fields):
   the fused powers binning (B9) on the normalized stacked transforms,
   the one-pass (B11a) and row-chunked (B11b: K4's kernel through its
   own entry) folded binning on fava_tpu-style folds whose 7 pad rows
   hold NaN, and the fused z+y transform (B12) on sqrt(rho)*v_x against
   their plain versions: B12's cluster FFT kernel (the ptxas report of
   its three builds, and each plan with its radices and occupancy,
   printed) at 512^3, on its mixed-radix route at the cuts 512x512x480,
   512x480x512 and 512x384x375 (odd z), and on its chirp route
   (Bluestein) at 512x512x502 (z = 2 x 251), 512x502x512, 512x509x509
   (both axes, odd z) and 512x512x1 (no z transform), and the dense
   kernel, on no route now, at 512^3 and 512x512x502 (the time before the
   chirp route), each launched once, against the float64 dense DFT and
   timed beside ``torch.fft.rfftn`` over y and z (the library call), and
   the FFT kernel's two-pass plan on an (8, 1024, 1024) volume; then the
   spectra five ways, each with
   counters: (a) the power volumes into K3 and K4, (m) the main path
   (cuFFT into one stack, B9), (c) B12 and cuFFT along x into B9, (d)/(e)
   the power volumes and fold padded as fava_tpu pads it into B11a/B11b;
   counts exact and sums held to (a) and to phase 4's float64 CPU path;
   then (c) on the fields cut to 512x512x480 (B12's mixed-radix route)
   and to 512x512x502 (its chirp route), each held to (a) on the same cut
   with exact counts; each path's entry and its two stages timed by CUDA
   events.
19. Stage 4's fractal dimension and structure functions (run after
   phase 12) on the 512^3 window as stage 4 reads it: the plt file's
   ``flam`` regridded to the window's uniform file (K7, its own
   directory), ``fractal_dimension(field="flam", contours=0.5)`` with
   its box counts equal to the plain float64 path's on the same float32
   values; ``structure_functions()``, ``structure_function_exponents``
   and ``velocity_increment_pdfs()`` with the pipeline's defaults on the
   window file's velocities, held to the float64 CPU path (TOL_STRUCTURE,
   TOL_SHIFT), with the share of draws whose gathered cell differs
   between the card and the CPU; warm walls.
20. Shell binning past 4095 shells (the walk's wide path, run after
   phase 18): a (16384, 64, 64) float32 volume (8191 shells) made on the
   card from a seed; K4, B4, B6 (a chunk at kx0 = 0), B10, B9, B11a and
   B11b against their plain versions (counts exact, sums within TOL_BIN
   per shell), each timed against its bound with its launch printed;
   then ``from_arrays(...).kinetic_energy_spectra()`` and
   ``flagship_analysis()`` with counters, held to the float64 CPU path
   (counts exact, spectra within TOL_SPECTRA of scale).
21. The pipeline on the card. First (after phase 19, on phase 6's files):
   ``flame_surface`` of the window's flam and the window's projections,
   and the plt file's AMR ``projection``, against the float64 CPU path
   (TOL_SURFACE, TOL_PROJECTION). Then, in a directory of its own:
   a. a two-snapshot plt series with phase 6's tree shape (its refined
      bands moving with the front, 4 finest blocks between snapshots;
      scripts/tpu_pipeline_bench.py's fields, computed on the card) and a
      pipeline_settings.json with the three fixed analyses plus scalar
      spectra, pdf2d, flame surface, projection, the eight velocity
      and gradient keys (enstrophy, helicity, dealiased transfer,
      decomposed and y-axis anisotropic spectra, the turbulence summary,
      the interior gradient statistics and Q-R PDF) and the three
      filtering and two-point keys (filtered ke flux, two point
      correlation of dens, velocity correlations); ``pipeline.main``
      in process with the counters reset around it: rc 0, two analysis
      files and two 512^3 uniform files, fava_tpu's checkpoint, no fit
      fallback and each centroid within PIPE_FIT_CELLS finest cells of
      the front, B9, K3, B4, K5, K6, K7 and B8 launched, and every
      stage-4 dataset equal (TOL_RERUN) to the analyses run again on the
      extracted files; the stage walls from the pipeline's prints.
   b. ``python -m fava_tpu_torch`` again in the same directory: rc 0, no
      work line but "window exists", the outputs byte-identical.
   c. a fresh three-snapshot series (PIPELINE_128.json's catalog):
      ``python -m fava_tpu_torch`` sent SIGINT twice after its first
      [stage 4] line; the checkpoint has stages 1 and 3 complete and stage
      4 short of the end; resumed to rc 0, its files hold an uninterrupted
      run's datasets (TOL_RERUN).
22. Velocity diagnostics and gradient statistics (run after phase 17, on
   the 512^3 window file phase 8 wrote): the signed helicity density
   through K3 + B4, and on the 511-wide cut through B10, against the
   plain versions (TOL_SIGNED_FOLD, TOL_BIN); B8 on the card's own Q and
   R, counts exact; the Helmholtz identities on the card; then the 11
   analyses through the Model, each with the counters reset before and
   its exact launches checked after (K3 + B4 once for the enstrophy,
   helicity and transfer spectra, three times for the decomposed
   spectra, B8 once for the Q-R PDF, nothing else), finite, timed warm,
   and held to the float64 CPU path on the same float32 values (the
   fields on a 128^3 cut; TOL_SPECTRA, TOL_TRANSFER of sum |T|,
   TOL_SUMS/TOL_SPECTRA for the summary, TOL_GRADIENT, MAX_QR_MOVED);
   the enstrophy spectrum of the 511-wide cut (B10); the pieces of the
   window's spectra, summary, gradients and Helmholtz split by CUDA
   events (layer_breakdown). Then a 512^3 file of seeded compressible,
   helical random velocity (RANDOM_SEED), which the window cannot stand
   in for: the Helmholtz identities, the helicity, transfer, decomposed
   spectra and the summary with Mach statistics, counted and held to the
   float64 path (transfer and flux to TOL_TRANSFER of sum |T|, the rest
   to their own scales), the fields on a 128^3 cut; the same file through
   the mesh with ``streamed=True`` (summary with Mach statistics, gradient
   statistics, velocity correlations, two-point lines) held to the
   in-core analyses on the card. Last, summary_series and gradient_series
   over phase 17's four files, each row held to the analysis of its file
   (TOL_RERUN).
23. Filtering and two-point analyses (after phase 22, on its two files):
   the correlation half-volume's shell binning (K3 + B4, and B10 on the
   511-wide cut) against the plain versions; on the window
   ``two_point_correlation("dens")`` (K3 + B4 counted),
   ``velocity_correlations()`` and ``filtered_kinetic_energy_flux()``
   with the pipeline's defaults, and the 511-wide cut's two-point
   correlation (B10 counted); on the random file the velocity
   correlations and the flux with pressure, gaussian and sharp; each
   counted, finite, timed warm, and held to the float64 CPU path on a
   128^3 cut (lines TOL_SPECTRA, integral scales where both runs cross
   zero at the same sample, the flux TOL_FLUX of its term scales; the
   sharp Favre flux printed only); identity (b), <Pi_l> = flux(k_c) on
   the file's solenoidal part at 512^3 (both sides on the card); the
   flux's pieces by CUDA events.
24. The particle analyses (after phase 21, in a directory of its own; no
   kernel on this path, and none may launch): a series of 9 part files
   of 1,000,000 tracers each, written with the port's
   ``write_particle_file`` (tag, posx/y/z, velx/y/z; the tag-keyed
   kinematics of scripts/tpu_particles_bench.py, x = x0 + u t and v =
   cos(omega t + phi), a fresh row order per file); through
   ``FLASH(d)``: ``load(file_type="prt")`` and ``statistics()`` (its
   columns float64 tensors on the card) against numpy,
   ``particle_series`` against float64 numpy on the tables (TOL_PRT),
   ``lagrangian_autocorrelation`` against the closed form and
   ``cross_correlation`` (the whole series and an ``ibeg``/``iend``
   window) against a recompute from the constructed tables (abs
   TOL_PRT), ``dispersion_statistics(npairs=1024)``: the partners equal
   to scipy's cKDTree's on the t = 0 coordinates, single_msd against
   <|u|^2> t^2 and pair_msd against a recompute from those partners
   (TOL_PRT), the float64 NN sweep alone by CUDA events;
   ``particle_structure_functions()`` with the defaults and with
   ``lengths=(1, 1, 1), num_pairs=4194304``, its counts equal to a
   float64 host oracle on the same draws and the moments within
   TOL_PAIR_MOMENTS; ``eulerian_autocorrelation(nsamples=65536,
   fields=["dens"])`` over two three-file plt series of 288 leaves, a
   static field (1 within TOL_PRT) and a translating one (held to the
   same driver on the CPU). Every call is made twice and its second
   (warm) wall printed, with the peak card memory and the phase's wall.
25. The sharded paths (after phase 23, on its window file): a one-rank
   NCCL world on cuda:0 (a file:// store in the phase's temp dir) with
   the meshes (1,) "space" and (1, 1) "snap", "space". A one-rank space
   axis takes the single-device paths, so the sharded functions are
   called directly on the 512^3 example fields, each with its exact
   launches: ``sharded_power_spectra`` (B6), the mesh branch of
   ``uniform_analysis_step`` (B6, K1, K2) and
   ``sharded_series_analysis_step`` on a batch of 2, held to the
   single-device step (counts exact, spectra TOL_SPECTRA, profiles
   TOL_PROFILES); ``pfft3`` equal to ``torch.fft.fftn`` and the pencil
   transform through the exchange within TOL_SPECTRA; virtual ranks: the
   global rfftn cut into d = 2, 4, 8 y-slabs, each binned by B6 at its
   offset, summed and held to the single-device sums (TOL_VIRTUAL), and
   B6 on a transposed slab against its plain twin, timed against its
   bound; ``FLASH(d)`` on the window file under the mesh
   (``load("uni")``, ``kinetic_energy_spectra``, ``flagship_analysis``)
   equal (TOL_BIN) to the same calls without one; the sharded and the
   single-device steps and the collectives alone by CUDA events.
26. AMR over devices and the pod series (after phase 25, on phase 6's plt
   file, phase 8's window and phase 17's files): a one-rank NCCL world on
   cuda:0 with the (1, 1) "snap", "space" mesh. A one-rank mesh takes the
   single-device paths, so the sharded pieces run on virtual ranks, each
   step with its exact launches: (a) K5/K6 on d = 2, 4, 8 virtual leaf
   shares of the 34,192 leaves (``ops/profiles``), concatenated and equal
   bit for bit to the single launch; (b) ``ShardedRegridPlan``'s per-rank
   tables and K7 on each virtual slab from its local stack, for the 512^3
   window (4 fields) and the 2048x512x512 full domain (dens), stacked and
   equal to the single regrid, each rank's bmax printed against nB; (c)
   ``flagship_series(batch=2)`` on the pod (B6, K1, K2 a snapshot) against
   the call without a mesh (K1, K2, B9; TOL_SPECTRA, TOL_PROFILES, counts
   exact); (d) ``reynolds_series`` and ``favre_series`` on phase 24's
   288-leaf plt series under the pod against the calls without one; (e)
   ``SnapshotPrefetcher`` with ``ingest_sharding_fn`` on the window file:
   the fields arrive whole. (a)-(c) timed by CUDA events.
27. The rank-local analyses (after phase 26, on phase 8's 512^3 window
   and phase 19's flam window): a one-rank NCCL world on cuda:0 with the
   (1,) "space" mesh. (a) The profiles (Reynolds and Favre along x: K1,
   K2; Reynolds along y; the slice integral along z), the volume
   integral and mass sum with a mask, the scalar spectrum (the pencil
   transform and the one-channel B6), the fractal dimension (0.5 and the
   mean), the structure functions and increment PDFs (the pipeline's
   defaults), the turbulence summary and the gradient statistics
   (periodic and interior), each through its ops entry with ``mesh=``
   the (1,) mesh and on the single device, with exact launches, held to
   each other (TOL_RANKLOCAL, TOL_SPECTRA, equality), with warm walls;
   (b) the rank-local bodies on d = 2, 4, 8 virtual ranks joined by
   ``SpaceRanks(d=d)``: launches exactly d, box counts equal, the
   structure family equal bit for bit, sums within the same bounds; (c)
   the one-channel B6 on a transposed (128, 512, 257) slab at kx0 = 128
   against its plain twin and its bound. (a) and (b) also run the slice
   of A11e: ``pdf1d`` and ``pdf2d`` (counted and mass-weighted),
   ``binned_statistic``, ``density_pdf``, the Q-R PDF (periodic and
   interior; B8 once a rank), the enstrophy, helicity, decomposed (plain
   and weighted; the one-channel B6 once a rank and binned density, 3
   for the decomposed spectra, where the single device runs K3 + the
   one-channel B4), anisotropic (x and y) and transfer (plain and
   dealiased, through the inverse pencil transform) spectra: counts
   equal on the mesh and for the MIN/MAX-edged PDFs on the virtual
   ranks, the cells of the density and Q-R PDFs that differ printed.
   At most 60 s.
28. The rank-local spectral analyses (after phase 27, on phase 8's 512^3
   window): a one-rank NCCL world on cuda:0 with the (1,) "space" mesh.
   (a) The filtered KE flux (the pipeline's defaults; and the sharp
   kernel with pressure, p = rho^(5/3) standing in for the window's
   missing pres), the two-point correlation of dens, the velocity
   correlations, and the Helmholtz parts, vorticity and dilatation
   (built on the host as the mesh's methods build them), each through
   its ops entry with ``mesh=`` the (1,) mesh and on the single device,
   with exact launches (the one-channel B6 once for the two-point
   correlation on the mesh, K3 + the one-channel B4 on the single device,
   no kernel for the others), held to each other (TOL_FLUX of the flux's
   term scales, TOL_SPECTRA for the lines and the Helmholtz parts, the
   derivative bound of helmholtz_identities for vorticity and
   dilatation), with warm walls;
   (b) the ranked bodies on d = 2, 4, 8 virtual ranks (the one-channel B6
   d times for the two-point correlation) against the single device; (c)
   the one-channel B6 on the (128, 512, 257) x-slab of the correlation
   half-volume at kx0 = 128 against its plain twin and its bound. At
   most 60 s.
29. The rank-local flame surface, projections, AMR-side PDFs and point
   sampling (after phase 28, on phase 8's 512^3 window and phase 19's
   flam window): a one-rank NCCL world on cuda:0 with the (1,) "space"
   mesh. (a) The flame surface along x and y, the projections (dens
   along x, velx weighted by dens along z), ``pdf1d``, ``pdf2d``
   (cell-volume and mass weighted, and counted), ``binned_statistic``
   and ``density_pdf`` on the window as a (1, 512, 512, 512) stack with
   its cell-volume weights, and the sampling of SURFACE_POINTS seeded
   cells, each through its ops entry with ``mesh=`` the (1,) mesh and on
   the single device, with exact launches (B8 once per pdf2d, nothing
   else), held to each other (TOL_RANKLOCAL of scale, TOL_WSUM per
   weighted bin, counts, edges, the maximum gradient and the sampled
   values exactly), with warm walls; (b) the ranked bodies on d = 2, 4,
   8 virtual ranks (B8 d times per pdf2d; the density PDF's counts may
   move TOL_SHIFT samples); (c) the weighted B8 on one (128, 512, 512)
   x-slab's samples against its plain twin and its bound. At most 60 s.
30. The device trace and the NaN checks (run last, on fresh 512^3
   example fields, beside phase 5's CUDA-event times: CUPTI stays
   attached after a trace, and the host time it adds to every later CUDA
   call would inflate the other phases' host-bound kernel times): one
   warm ``flagship_analysis`` under
   ``utils.profiling.device_trace`` with an ``annotate("flagship_step")``
   span and ``timing.trace("flagship_step")``; the trace file parsed: K1,
   K2, K3 and K4 found by their CUDA names as often as their launch
   counters say, inside the span; the top 5 device operations by total
   time, the device-busy share of the span (the union of kernel, copy and
   memset intervals over its length) and each kernel's traced time beside
   phase 5's CUDA-event time, printed with the card's name and power
   limit; the same for one ``kinetic_energy_spectra`` (span
   "spectra_step"). Then, under
   ``utils.debug.enable_checks()``, the step on clean 64^3 example fields
   runs, the same fields with one NaN planted in dens raise
   FloatingPointError, and K4 on a power volume holding a NaN raises it
   naming the kernel; after ``disable_checks()`` the planted NaN goes
   through. At most 20 s.

The last two lines are one JSON object with a row per kernel, then
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 512
NSNAP = 4
NAMES = ("dens", "velx", "vely", "velz")
SOURCES = {
    "row_moments": "fava_tpu_torch/csrc/flagship_kernels.cu",
    "centered_row_moments": "fava_tpu_torch/csrc/flagship_kernels.cu",
    "fold_quadrants_pair": "fava_tpu_torch/csrc/flagship_kernels.cu",
    "shell_bin_values_folded": "fava_tpu_torch/csrc/shell_bins.cuh",
    "block_row_moments": "fava_tpu_torch/csrc/amr_kernels.cu",
    "block_centered_row_moments": "fava_tpu_torch/csrc/amr_kernels.cu",
    "regrid_fields": "fava_tpu_torch/csrc/amr_kernels.cu",
    "shell_bin_values_folded_1ch": "fava_tpu_torch/csrc/shell_bins.cuh",
    "shell_bin_sums_unfolded": "fava_tpu_torch/csrc/shell_bins.cuh",
    "pdf2d_counts": "fava_tpu_torch/csrc/pdf2d_kernels.cu",
    "pdf2d_weighted": "fava_tpu_torch/csrc/pdf2d_kernels.cu",
    "shell_bin_values_rfft_chunk": "fava_tpu_torch/csrc/shell_bins.cuh",
    "shell_bin_values_rfft_chunk_1ch": "fava_tpu_torch/csrc/shell_bins.cuh",
    "shell_bin_powers_fused": "fava_tpu_torch/csrc/fused_spectra_kernels.cu",
    "shell_bin_sums_folded_onepass": "fava_tpu_torch/csrc/shell_bins.cuh",
    "shell_bin_values_folded_rows": "fava_tpu_torch/csrc/shell_bins.cuh",
    "zy_rfft_planar": "fava_tpu_torch/csrc/zy_fft.cuh",
    "zy_rfft_planar_dense": "fava_tpu_torch/csrc/dft_kernels.cu",
}
REPLACES = {
    "row_moments": "fava_tpu/ops/pallas_kernels.py:95",
    "centered_row_moments": "fava_tpu/ops/pallas_kernels.py:200",
    "fold_quadrants_pair": "fava_tpu/ops/pallas_kernels.py:678",
    "shell_bin_values_folded": "fava_tpu/ops/pallas_kernels.py:955",
    "block_row_moments": "fava_tpu/ops/pallas_kernels.py:331",
    "block_centered_row_moments": "fava_tpu/ops/pallas_kernels.py:352",
    "regrid_fields": "fava_tpu/ops/pallas_regrid.py:78",
    "shell_bin_values_folded_1ch": "fava_tpu/ops/pallas_kernels.py:955",
    "shell_bin_sums_unfolded": "fava_tpu/ops/pallas_kernels.py:515",
    "pdf2d_counts": "fava_tpu/ops/pallas_pdf2d.py:75",
    "pdf2d_weighted": "fava_tpu/ops/pallas_pdf2d.py:91",
    "shell_bin_values_rfft_chunk": "fava_tpu/ops/pallas_kernels.py:1291",
    "shell_bin_values_rfft_chunk_1ch": "fava_tpu/ops/pallas_kernels.py:1291",
    "shell_bin_powers_fused": "fava_tpu/ops/pallas_kernels.py:1539",
    "shell_bin_sums_folded_onepass": "fava_tpu/ops/pallas_kernels.py:758",
    "shell_bin_values_folded_rows": "fava_tpu/ops/pallas_kernels.py:851",
    "zy_rfft_planar": "fava_tpu/experiments/pallas_dft.py:53",
    "zy_rfft_planar_dense": "fava_tpu/experiments/pallas_dft.py:53",
}
FLAGSHIP_KERNELS = ("row_moments", "centered_row_moments", "shell_bin_powers_fused")
AMR_KERNELS = ("block_row_moments", "block_centered_row_moments", "regrid_fields")
# Kernel vs plain float64 version on the same values (see phase_kernels).
TOL_MOMENTS = 1e-10  # of the sum of |terms|: f64 sums of 2.6e5 terms, n*eps ~ 3e-11
TOL_FOLD = 2e-7  # relative: <= 3 float32 roundings of a sum of <= 4 positive terms
TOL_BIN = 1e-9  # relative per shell: f64 sums of <= ~1e6 positive terms in another order
# Main path (float32 fields, float64 sums) vs the plain float64 path on the
# CPU, as max |diff| / scale per output (see phase_main): the spectra carry
# float32 FFT and power rounding; the profiles only summation order.
TOL_SPECTRA = 1e-5
TOL_PROFILES = 1e-9
# Stage 4 (phases 10-12). Histogram counts are exact: each float32 sample
# is compared as its exact double against the same float64 edges on both
# sides. Weighted bin sums: f64 sums of the same float32 products in
# another order (atomics on the card), relative per bin. Moments, means and
# volume sums: f64 sums of ~1.4e8 terms in another order, as max |diff| /
# max(|ref|, 1). density_pdf bins s = ln(rho/<rho>), whose log may differ by
# an ulp between the card and the CPU and whose edges come from the moments:
# at most TOL_SHIFT samples may change bin in all.
TOL_WSUM = 1e-10
TOL_SUMS = 1e-9
TOL_SHIFT = 2

# The least time of each kernel (bound_ms in the kernels line): the larger
# of the bytes it must move (each input it needs read once, each output
# written once) over the memory rate and its arithmetic over the float32
# rate outside the tensor cores; NVIDIA H100 SXM, at its full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The fused-spectrum path (phase 18). B12 against the float64 dense DFT, as
# max |diff| / max |coefficient|: float32 products summed in a fixed order
# (~1e-7 expected). Path (c) against (a) and against the float64 path, as
# max |diff| / scale per spectrum: TOL_SPECTRA for the float32 transforms
# and powers, plus 2 TOL_ZY for the power of a coefficient that carries
# B12's relative error e (|W (1 + e)|^2 = |W|^2 (1 + 2e + e^2)); the shells
# that set the scale hold the largest coefficients, whose relative error is
# at most TOL_ZY.
TOL_ZY = 1e-5
TOL_ZY_PATH = TOL_SPECTRA + 2 * TOL_ZY

# Phase 19: the structure functions and increment PDFs draw, gather and sum
# in float64 on both sides, from the same Threefry words; the float32 file
# values widen exactly. The card and the CPU then differ by the last-place
# rounding of acos/sin/cos (a drawn direction's error, amplified at most
# R/s ~ 1.3e3 in the wrapped unit vector at the smallest separation s, and
# 10-fold by the 10th power) and by the sums' order: 1e-9 of each value
# (moments: of max(|ref|, std)). A gathered cell can differ only at an
# ulp-level tie with a cell boundary (about one endpoint in a million on
# the H100 against its host's libm): a separation whose draw holds such a
# pair is held to TOL_TIE instead, one moved sample of N (10^4 or 65536)
# changing a mean by its neighbour difference over N, and the exponents,
# which fit every separation, to TOL_TIE when any pair moved; the share is
# printed and held to MAX_TIE_SHARE.
TOL_STRUCTURE = 1e-9
TOL_TIE = 1e-3
MAX_TIE_SHARE = 1e-5
# Phase 20: a (16384, 64, 64) volume, 8191 shells, made on the card.
WIDE_SHAPE = (16384, 64, 64)

# Phase 22: the velocity diagnostics and gradient statistics on the window.
# The signed helicity density through K3 + B4: K3 adds up to 4 float32 terms
# in 3 roundings, each within 2^-24 of the sum of their magnitudes; B4 then
# sums those float32 values in float64 (TOL_BIN). Against the float64 path:
# transfer and flux, cancellations of signed products, within TOL_TRANSFER
# of the sum of the products' magnitudes (float32 transforms and products,
# ~1e-7 relative each; the helicity spectrum likewise, TOL_SPECTRA of its
# largest shell bound: signed_scales); each entry of the gradient statistics within TOL_GRADIENT of its
# natural scale (gradient_scales; float32 differences and their scaling by
# 1/(2 dx), ~1e-7 relative, raised to the 4th power); the Q-R histogram
# within MAX_QR_MOVED of the cells moved (float32 Q and R change bin only
# within ~1e-6 of an edge); the Helmholtz fields on a CUT_FIELDS^3 cut.
TOL_SIGNED_FOLD = 3 * 2.0**-24
TOL_IDENTITY = 2.0**-20  # 16 float32 roundings (helmholtz_identities)
TOL_TRANSFER = 1e-5
TOL_GRADIENT = 1e-5
MAX_QR_MOVED = 1e-4
CUT_FIELDS = 128
# The window's velocity has no divergence, helicity or transfer, so on it
# those analyses meet only rounding. Phase 22 therefore also runs them on
# a 512^3 uniform file of seeded random velocity (every component a
# Gaussian field with E(k) ~ k^-5/3: compressible, helical, with transfer),
# lognormal density, polytropic pressure and a per-cell gamc. There
# transfer and flux are held to TOL_TRANSFER of sum |T| (as measured by the
# float64 path), every other array to its own scale, and the file must
# carry at least MIN_COMPRESSIVE of its energy in the compressive part.
RANDOM_SEED = 22
RANDOM_RUNS = ("helicity spectra", "transfer spectra", "decomposed spectra", "turbulence summary")
MIN_COMPRESSIVE = 0.1
# Phase 23: the filtered flux against the float64 path on a cut, each
# cutoff's mean and rms within TOL_FLUX of its term scale (flux_term_scales:
# the magnitudes whose difference tau is, times the velocity gradient;
# float32 transforms and products, ~1e-7 relative each, through ~22 inverse
# transforms and a quotient by rho_b). Identity (b): the sharp filter at
# k_c = s + 0.5 for these shells s (3 k_c < 512).
TOL_FLUX = 1e-5
IDENTITY_SHELLS = (8, 32, 128)

# The AMR path (phases 6-9): an rtflame-like tree, refined around the
# flame at x in [1.5, 2.5] (see amr_refine), and the flame window regridded
# to 512^3. The plain float64 path reads the same float32 file values, so
# the profiles differ only in summation order (bound as TOL_PROFILES).
AMR_NCELLS = (16, 16, 16)
AMR_NBLKS = (4, 1, 1)
AMR_DOMAIN = ((0.0, 4.0), (0.0, 1.0), (0.0, 1.0))
AMR_LEVELS = ((1.5, 2.5, 6), (1.375, 2.625, 5), (1.125, 2.875, 4))  # (lo, hi, level) bands
AMR_BASE_LEVEL = 2
AMR_WINDOW = ((1.5, 2.5), (0.0, 1.0), (0.0, 1.0))
AMR_EXPECT = {"blocks": 39076, "leaves": 34192, "window": (512, 512, 512), "full": (2048, 512, 512)}

# Phase 21: the pipeline (python -m fava_tpu_torch) on the card. 21a: two
# snapshots with phase 6's tree shape, its refined bands moved with a front at
# x_f(t) = PIPE_XF0 + PIPE_SPEED * t, which moves 4 finest-level blocks (4/32)
# between them; a 1.0-wide window, 512 cells at dx 1/512.
PIPE_TIMES = (0.0, 1.0)
PIPE_XF0, PIPE_SPEED = 1.9375, 0.125
PIPE_FIELDS = ("flam", "dens", "pres", "temp", "velx", "vely", "velz")
PIPE_HALF_WIDTH = 0.5
PIPE_WINDOW = (512, 512, 512)
PIPE_STRUCTURE = {"num_seps": 100, "num_points": 10000, "sep_bounds": [0.01, 0.45]}
PIPE_EXTRA = {
    "scalar spectra": {"skip": False, "settings": {"field": "flam"}},
    "pdf2d": {"skip": False, "settings": {"field1": "dens", "field2": "flam"}},
    "flame surface": {"skip": False, "settings": {"field": "flam"}},
    "projection": {"skip": False, "settings": {"field": "dens", "axis": 0}},
    "enstrophy spectra": {"skip": False},
    "helicity spectra": {"skip": False},
    "transfer spectra": {"skip": False, "settings": {"dealias": True}},
    "decomposed spectra": {"skip": False},
    "anisotropic spectra": {"skip": False, "settings": {"axis": 1}},
    "turbulence summary": {"skip": False},
    "velocity gradient statistics": {"skip": False, "settings": {"boundary": "interior"}},
    "gradient invariant pdfs": {"skip": False, "settings": {"boundary": "interior"}},
    "filtered ke flux": {"skip": False},
    "two point correlation": {"skip": False, "settings": {"field": "dens"}},
    "velocity correlations": {"skip": False},
}
# Stage-4 keys of the settings and the Model method each runs.
PIPE_STAGE4 = {"fractal dimension": "fractal_dimension", "structure functions": "structure_functions",
               "kinetic energy spectra": "kinetic_energy_spectra", "scalar spectra": "scalar_spectra",
               "pdf2d": "pdf2d", "flame surface": "flame_surface", "projection": "projection",
               "enstrophy spectra": "enstrophy_spectra", "helicity spectra": "helicity_spectra",
               "transfer spectra": "transfer_spectra",
               "decomposed spectra": "decomposed_kinetic_energy_spectra",
               "anisotropic spectra": "anisotropic_kinetic_energy_spectra",
               "turbulence summary": "turbulence_summary",
               "velocity gradient statistics": "velocity_gradient_statistics",
               "gradient invariant pdfs": "gradient_invariant_pdfs",
               "filtered ke flux": "filtered_kinetic_energy_flux",
               "two point correlation": "two_point_correlation",
               "velocity correlations": "velocity_correlations"}
# B9, K3, B4 (stage 4 spectra), K5, K6 (stage 1), K7 (stage 3), B8 (pdf2d).
PIPE_KERNELS = ("shell_bin_powers_fused", "fold_quadrants_pair", "shell_bin_values_folded_1ch",
                "block_row_moments", "block_centered_row_moments", "regrid_fields", "pdf2d_counts")
PIPE_WORK_LINES = ("[stage 1] reynolds stress", "[stage 3] extract window", "[stage 3] window exists",
                   "[stage 4] uniform analyses", "pipeline complete")
# Stage 1's centroid is the peak of the density-weighted Ryy + Rzz (fava_tpu's
# fit starts there and, with the sigma guess its XFACT scaling gives on this
# domain, stays there): by the fields' construction ~0.024 behind x_f, 12.5
# finest cells at dx 1/512 (a float64 sum over a 128^2 y-z grid).
PIPE_FIT_CELLS = 16
# The analysis file's stage-4 datasets against the same analyses run again in
# process on the extracted file, and 21c's files against an uninterrupted
# run's (the same float32 values and draws; float64 atomics may add in another
# order): max |diff| per dataset, of max(its largest |value|, 1).
TOL_RERUN = 1e-12
# flame_surface on the card (float32 differences and magnitudes, float64 plane
# means) against the float64 CPU path on the same values: relative per value,
# sigma of its largest. Projections sum the same widened values in float64 on
# both sides: max |diff| of the largest |value|.
TOL_SURFACE = 1e-6
TOL_PROJECTION = 1e-12
# 21c: three snapshots as PIPELINE_128.json's catalog (scripts/tpu_pipeline_bench.py
# at N = 128: 32^3-cell blocks on 8x2x2 roots, level 2 around the front).
SMALL_TIMES = (0.0, 0.25, 0.5)
SMALL_XF0, SMALL_SPEED = 0.9, 0.4
SMALL_FIELDS = ("flam", "dens", "temp", "velx", "vely", "velz")
SMALL_NCELLS, SMALL_NBLKS = (32, 32, 32), (8, 2, 2)


def amr_refine(bounds, level):
    """Target level of a block by its x extent: the flame band and the
    two shoulders around it, coarse elsewhere."""
    lo, hi = bounds[0]
    for band_lo, band_hi, target in AMR_LEVELS:
        if hi > band_lo and lo < band_hi:
            return target
    return AMR_BASE_LEVEL


def amr_flam(np):
    """The flame progress variable of the AMR file: 0 in the fuel, 1
    behind a front at x = 2 (the window's middle, inside the finest band)
    wrinkled by two modes across y and z, about 8 finest cells thick."""
    def flam(x, y, z):
        front = (2.0 + 0.08 * np.sin(6 * np.pi * y) * np.cos(4 * np.pi * z)
                 + 0.03 * np.sin(22 * np.pi * y + 1.0) * np.sin(14 * np.pi * z))
        return 1.0 / (1.0 + np.exp(-60.0 * (x - front)))

    return flam


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
    try:
        import scipy
    except ImportError:
        fail("scipy does not import: pipeline stage 1 fits the flame window with scipy")
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__}; torch.version.cuda {torch.version.cuda}; "
        f"nvcc {nvcc}: {release[0].strip() if release else ver.stdout.strip()}; triton {triton_state}; "
        f"scipy {scipy.__version__}")
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
    compiles = [ln[3:] for ln in (_build.BUILD_LOG or "").splitlines() if ln.startswith("== ")]
    say(f"phase 2 compile seconds, one nvcc a source, all at once: {'; '.join(compiles)}")
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


def least_time(nbytes, ops):
    """{"bound_ms", "bound_by"} of a kernel that moves ``nbytes`` and does
    ``ops`` arithmetic operations."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def zy_fft_ops(nx, ny, nz):
    """Operations of B12's function done the cheapest known way, as FFTs
    (cuFFT computes it so): a real z-transform of each of the nx*ny rows,
    2.5 nz log2 nz, and a complex y-transform of each of the nx*(nz/2+1)
    columns, 5 ny log2 ny. B12's dense DFT does O(n) times more."""
    return nx * ny * 2.5 * nz * math.log2(max(nz, 2)) + nx * (nz // 2 + 1) * 5 * ny * math.log2(max(ny, 2))


def kernel_row(torch, phase, name, max_abs, ratio, bound, kernel_fn, plain_fn, work):
    """Print and check a kernel-vs-plain comparison; time both (CUDA events).
    ``work`` is (bytes, operations) of the kernel's call. library_ms is null:
    no single PyTorch call computes these kernels' functions on the card
    (the caller of the one kernel that has one, B12, fills it in)."""
    say(f"phase {phase} {name}: max_abs_err {max_abs!r}, error/bound {ratio!r} (bound {bound!r})")
    if not ratio <= 1.0:
        fail(f"{name} disagrees with its plain version (error/bound {ratio!r})")
    return {"max_abs_err": max_abs, "ms": cuda_ms(torch, kernel_fn, 20),
            "plain_ms": cuda_ms(torch, plain_fn, 3), **least_time(*work), "library_ms": None}


def inside_cells(ck, vol, nbins, full_ny=None, full_nz=None, kx0=0, full_nx=None):
    """Cells a shell-binning kernel must read of ``vol``: those inside the
    last shell of a folded volume (``full_ny`` given) or of an unfolded
    half-spectrum."""
    shape = tuple(vol.shape)
    if full_ny is not None:
        shell = ck._folded_shells(shape, nbins, full_ny, vol.device)
    else:
        shell = ck._unfolded_shells(shape, nbins, full_nz, vol.device, kx0, full_nx)[0]
    return int((shell < nbins).sum())


def path_powers(torch, fields):
    from fava_tpu_torch.ops.spectra import kinetic_power_volumes

    return kinetic_power_volumes(fields[0], fields[1:])


def phase_kernels(torch, fields):
    from fava_tpu_torch.ops import cuda_kernels as ck

    nx, ny, nz = fields[0].shape
    layer = float(ny * nz)
    nbins = max(nx, ny, nz) // 2 - 1
    f64 = [f.double() for f in fields]
    rows = {}

    def record(name, got, ref, bound, err_ratio, kernel_fn, plain_fn, work):
        max_abs = float((got.double() - ref).abs().max())
        rows[name] = kernel_row(torch, 3, name, max_abs, err_ratio, bound, kernel_fn, plain_fn,
                                work)

    ncell = nx * ny * nz

    # K1: |got - ref| against the sum of |terms| (plain moments of |fields|).
    got = ck.row_moments_volume(*fields)
    torch.cuda.synchronize()
    ref = ck._row_moments_plain(*f64)
    mag = ck._row_moments_plain(*(f.abs() for f in f64))
    record("row_moments", got, ref, TOL_MOMENTS,
           float(((got - ref).abs() / (TOL_MOMENTS * mag)).max()),
           lambda: ck.row_moments_volume(*fields), lambda: ck._row_moments_plain(*fields),
           (16 * ncell + 8 * ck.NMOM * nx, 22 * ncell))

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
           lambda: ck._centered_plain(*fields, means),
           (16 * ncell + 8 * (3 + ck.NCEN) * nx, 21 * ncell))
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
           lambda: (ck._fold_plain(total), ck._fold_plain(longi)),
           (8 * total.numel() + 8 * folded[0].numel(), 2 * total.numel()))
    del total, longi

    # K4 on the folded volumes; run twice to show the atomics' spread.
    got = ck.shell_bin_values_folded(*folded, nbins, ny, nz)
    again = ck.shell_bin_values_folded(*folded, nbins, ny, nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_folded_plain(*(a.double() for a in folded), nbins, ny, nz)
    say(f"phase 3 shell_bin_values_folded: run-to-run max |diff| {float((got - again).abs().max())!r}")
    inside = inside_cells(ck, folded[0], nbins, full_ny=ny)
    record("shell_bin_values_folded", got, ref, TOL_BIN,
           float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max()),
           lambda: ck.shell_bin_values_folded(*folded, nbins, ny, nz),
           lambda: ck._shell_bin_folded_plain(*folded, nbins, ny, nz),
           (8 * inside + 16 * nbins, 8 * inside))
    nxh, nyh, nzr = folded[0].shape
    walk_report(torch, ck, 3, "shell_bin_values_folded", rows["shell_bin_values_folded"],
                ck.walk_launch("fava_shell_bin_folded_blocks_per_sm", (2, 0), 2, nxh * nyh, nbins),
                "fava_shell_bin_values_folded", folded[0].data_ptr(), folded[1].data_ptr(),
                got.data_ptr(), nxh, nyh, nzr, nbins, ny, nz, 2)
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
    counts = ck._folded_counts((nx // 2 + 1, ny // 2 + 1, nz // 2 + 1), nbins, nx, ny, nz, "cuda")
    if not (np.asarray(out["spectra_counts"]) == counts).all():
        fail(f"{where}: spectra_counts differ from the static counts")


def output_floors(fields):
    """Floors of the flagship outputs' scales: each output's scale is its
    largest magnitude, floored by the field scale for outputs that can
    vanish up to rounding (the trig fields' row means of v are ~0), as
    fava_tpu's float32 step test normalizes."""
    vmax = max(float(v.abs().max()) for v in fields[1:])
    return {"favre_mean": vmax, "favre_rms": vmax,
            "reynolds_stress": float(fields[0].abs().max()) * vmax**2}


def compare_flagship(np, out, ref, fields, what, phase, bound_of=None):
    """max |diff| / scale of each flagship output against a reference (the
    float64 path unless ``bound_of`` maps keys to other bounds); ``fields``
    are the input tensors, or their output_floors."""
    floor = fields if isinstance(fields, dict) else output_floors(fields)
    errs = {}
    for key, r in ref.items():
        r = np.asarray(r)
        scale = max(float(np.abs(r).max()), floor.get(key, 0.0))
        errs[key] = float(np.abs(np.asarray(out[key]) - r).max() / scale)
        if bound_of is not None:
            bound = bound_of(key)
        else:
            bound = TOL_SPECTRA if key.startswith("spectra_") else TOL_PROFILES
        say(f"phase {phase} {what} {key}: max|diff|/scale {errs[key]!r} (bound {bound!r})")
        if not errs[key] <= bound:
            fail(f"{what} {key} disagrees with its reference")
    return errs


def phase_main(torch, np, fields):
    import fava_tpu_torch
    from fava_tpu_torch import flagship
    from fava_tpu_torch.ops import cuda_kernels as ck

    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)))
    ck.reset_launch_counts()
    out = model.flagship_analysis()
    launches = ck.launch_counts()
    say(f"phase 4 flagship_analysis launches: {launches}")
    if any(launches[k] == 0 for k in FLAGSHIP_KERNELS):
        fail(f"a kernel of the path was never launched: {launches}")
    check_outputs(np, out, (N, N, N), "single")

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref = flagship.uniform_analysis_step(*(f.double().cpu() for f in fields))
    say(f"phase 4 plain float64 path on the CPU: {time.perf_counter() - t0:.1f} s")
    errs = compare_flagship(np, out, ref, fields, "flagship_analysis", 4)
    floor = output_floors(fields)
    ref_spectra = {k: v for k, v in ref.items() if k.startswith("spectra_")}
    del ref

    batch = flagship.make_example_field_batch(NSNAP, N)
    ck.reset_launch_counts()
    series = flagship.series_analysis_step(*batch)
    torch.cuda.synchronize()
    s_launch = ck.launch_counts()
    say(f"phase 4 series_analysis_step x{NSNAP} launches: {s_launch}")
    if any(s_launch[k] != NSNAP for k in FLAGSHIP_KERNELS):
        fail(f"series run launched {s_launch}, expected {NSNAP} each")
    series = {k: v.cpu().numpy() for k, v in series.items()}
    check_outputs(np, series, (N, N, N), "series")
    # Snapshot 0 is the single step's input: equal up to the binning atomics.
    for key, v in out.items():
        d = float(np.abs(series[key][0] - v).max() / max(np.abs(v).max(), floor.get(key, 0.0)))
        if not d <= TOL_BIN:
            fail(f"series snapshot 0 {key} differs from the single step by {d!r}")
    say("phase 4 series snapshot 0 equals the single step (within the binning tolerance)")
    return launches, errs, model, batch, ref_spectra


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
    from fava_tpu_torch.ops.spectra import kinetic_transforms

    dens, vx, vy, vz = fields
    nx, ny, nz = dens.shape
    nbins = max(nx, ny, nz) // 2 - 1
    layer = float(ny * nz)
    names = ("fft", "spectra", "moments", "centered", "assembly")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    ev[0].record()
    spec = torch.view_as_real(kinetic_transforms(dens, (vx, vy, vz)))
    ev[1].record()
    ck.shell_bin_powers_fused(spec[..., 0], spec[..., 1], nbins, nz)
    del spec
    ev[2].record()
    mom = ck.row_moments_volume(dens, vx, vy, vz)
    ev[3].record()
    means = (mom[1:4] / layer).contiguous()
    cen = ck.centered_row_moments(dens, vx, vy, vz, means)
    ev[4].record()
    assemble_profile_stats(mom[0], means, cen[6:9], cen[:6], layer)
    ev[5].record()
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
    return stages

# ---------------------------------------------------------------------------
# Phase 30: the device trace and the NaN checks (run last)

# Launch counter -> the CUDA name of its kernel in a trace (demangled).
TRACE_KERNELS = {
    "row_moments": r"(?<![A-Za-z_])row_moments_kernel\b",
    "centered_row_moments": r"(?<![A-Za-z_])centered_row_moments_kernel\b",
    "fold_quadrants_pair": r"(?<![A-Za-z_])fold_pair_kernel\b",
    "shell_bin_powers_fused": r"(?<![A-Za-z_])powers_fold_bin_kernel\b",
    "shell_bin_values_folded": r"(?<![A-Za-z_])shell_walk_kernel<2, false, [^,]*FoldedRows\b",
    "shell_bin_values_folded_1ch": r"(?<![A-Za-z_])shell_walk_kernel<1, false, [^,]*FoldedRows\b",
}
# Phase 5's CUDA-event stage of each flagship kernel.
STAGE_OF = {"row_moments": "moments", "centered_row_moments": "centered",
            "shell_bin_powers_fused": "spectra"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_PHASE_S = 20.0  # the phase's own budget


def traced(torch, ck, trace_dir: Path, span: str, fn):
    """``fn()`` under device_trace with an ``annotate(span)`` span and
    ``timing.trace(span)``, its launches counted; (launches, the trace's
    complete events)."""
    from fava_tpu_torch.utils import profiling, timing

    ck.reset_launch_counts()
    with profiling.device_trace(trace_dir, device="cuda"):
        with profiling.annotate(span), timing.trace(span):
            fn()
    launches = ck.launch_counts()
    (trace,) = trace_dir.glob("*.pt.trace.json")
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    if len(timing.timings().get(span, ())) != 1:
        fail(f"phase 30: timing.trace({span!r}) recorded {timing.timings().get(span)}")
    return launches, events


def trace_report(launches, events, span: str, what: str):
    """Hold the trace of one call to its launch counts and report it: each
    counted kernel by its CUDA name, as often as it launched, inside the
    outermost ``span`` span; the top 5 device operations by total time
    there; the union of device intervals over the span's length."""
    import re

    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == span]
    if not spans:
        fail(f"phase 30 {what}: no {span!r} span in the trace")
    s = max(spans, key=lambda e: e["dur"])
    lo, hi = s["ts"], s["ts"] + s["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        fail(f"phase 30 {what}: the trace holds no device event")
    inside = [e for e in device if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    counted = {k: v for k, v in launches.items() if v}
    if not counted or not set(counted) <= set(TRACE_KERNELS):
        fail(f"phase 30 {what}: launches {counted}, not all with a CUDA name to find")
    kernel_ms = {}
    for name, n in counted.items():
        pat = re.compile(TRACE_KERNELS[name])
        anywhere = [e for e in device if e.get("cat") == "kernel" and pat.search(e["name"])]
        hits = [e for e in anywhere if e in inside]
        if len(anywhere) != n or len(hits) != n:
            fail(f"phase 30 {what}: {name} launched {n} times; the trace holds {len(anywhere)} "
                 f"of its kernel, {len(hits)} inside the {span!r} span")
        kernel_ms[name] = sum(e["dur"] for e in hits) / n / 1e3
    totals = {}
    for e in inside:
        t = totals.setdefault(e["name"], [0.0, 0])
        t[0] += e["dur"] / 1e3
        t[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]
    busy, end = 0.0, lo
    for e in sorted(inside, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    return {
        "span_ms": s["dur"] / 1e3,
        "device_busy_share": busy / s["dur"],
        "device_events": len(inside),
        "top5_device_ops": [{"name": n[:120], "total_ms": t, "count": c} for n, (t, c) in top],
        "kernel_traced_ms": kernel_ms,
        "device_annotation": any(e.get("cat") == "gpu_user_annotation" and e["name"] == span
                                 for e in events),
    }


def nan_trap(torch, np, ck):
    """Under enable_checks(): clean 64^3 example fields run the step; one
    NaN planted in dens raises FloatingPointError; K4 on a power volume
    holding a NaN raises it naming the kernel. After disable_checks() the
    planted NaN goes through. Returns the two errors' messages."""
    import fava_tpu_torch
    from fava_tpu_torch import flagship
    from fava_tpu_torch.utils import debug

    fields = flagship.make_example_fields(64)
    planted = [f.clone() for f in fields]
    planted[0][3, 5, 7] = float("nan")
    clean_model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)))
    nan_model = fava_tpu_torch.from_arrays(dict(zip(NAMES, planted)))
    gen = torch.Generator(device="cuda").manual_seed(30)
    total, longi = (torch.rand((33, 33, 33), generator=gen, device="cuda") for _ in range(2))
    total[1, 1, 1] = float("nan")
    torch.cuda.synchronize()
    errors = {}
    try:
        debug.enable_checks()
        out = clean_model.flagship_analysis()
        if not all(np.isfinite(np.asarray(v)).all() for v in out.values()):
            fail("phase 30: the clean step's outputs are not finite")
        for what, fn in (("op", nan_model.flagship_analysis),
                         ("kernel", lambda: ck.shell_bin_values_folded(total, longi, 31, 64, 64))):
            try:
                fn()
            except FloatingPointError as e:
                errors[what] = str(e)
            else:
                fail(f"phase 30: a NaN ({what}) went through enable_checks()")
    finally:
        debug.disable_checks()
    if "shell_bin_values_folded" not in errors["kernel"]:
        fail(f"phase 30: K4's NaN error does not name the kernel: {errors['kernel']}")
    out = nan_model.flagship_analysis()
    if not np.isnan(np.asarray(out["mean_dens"])).any():
        fail("phase 30: after disable_checks() the planted NaN did not reach mean_dens")
    return errors


def phase_trace(torch, np, model, stages, card):
    """One warm flagship_analysis and one kinetic_energy_spectra of the
    512^3 example fields under device_trace, held to their launch counts
    and reported beside phase 5's CUDA-event times; then the NaN trap.
    Returns the traced runs' launches."""
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.utils import timing

    t_phase = time.perf_counter()
    model.flagship_analysis()  # warm
    model.kinetic_energy_spectra()
    torch.cuda.synchronize()
    totals = {}
    with tempfile.TemporaryDirectory(prefix="fava_trace_") as tmp:
        # (not "kinetic_energy_spectra": its @timer records under that name)
        for span, fn in (("flagship_step", model.flagship_analysis),
                         ("spectra_step", model.kinetic_energy_spectra)):
            timing.reset_timings()
            launches, events = traced(torch, ck, Path(tmp) / span, span, fn)
            if span == "flagship_step" and any(launches[k] != 1 for k in FLAGSHIP_KERNELS):
                fail(f"phase 30: the traced step launched {launches}")
            report = trace_report(launches, events, span, span)
            report["host_wall_s"] = timing.timings()[span][0]
            report["phase5_cuda_event_ms"] = {k: stages[STAGE_OF[k]] for k in report["kernel_traced_ms"]
                                              if k in STAGE_OF}
            say(f"phase 30 trace {span}: {json.dumps({'card': card, **report})}")
            add_counts(totals, launches)
    timing.reset_timings()
    errors = nan_trap(torch, np, ck)
    say(f"phase 30 NaN trap: {json.dumps(errors)}")
    secs = time.perf_counter() - t_phase
    say(f"phase 30 seconds {secs!r}; {card}")
    if secs > TRACE_PHASE_S:
        fail(f"phase 30 took {secs:.1f} s, over its {TRACE_PHASE_S} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 6: the AMR file and its load


def phase_amr_file(torch, np, workdir: Path):
    import fava_tpu_torch
    from fava_tpu_torch.io import synthetic

    t0 = time.perf_counter()
    synthetic.make_amr_file(
        workdir / "rt_hdf5_plt_cnt_0001", ncells=AMR_NCELLS, nblks=AMR_NBLKS,
        domain=np.array(AMR_DOMAIN), refine_fn=amr_refine, field_fns={"flam": amr_flam(np)},
    )
    synth_s = time.perf_counter() - t0
    model = fava_tpu_torch.FLASH(workdir)
    model.load(file_type="plt")
    mesh = model.mesh
    leaves = int(mesh.get_blocklist("LEAF").size)
    say(f"phase 6 AMR file: {mesh.nblocks} blocks, {leaves} leaves, levels "
        f"{sorted(set(np.asarray(mesh.refine_level).tolist()))}, file "
        f"{(workdir / 'rt_hdf5_plt_cnt_0001').stat().st_size / 1e9:.3f} GB, synthesis and write "
        f"{synth_s!r} s")
    if (mesh.nblocks, leaves) != (AMR_EXPECT["blocks"], AMR_EXPECT["leaves"]):
        fail(f"AMR tree has {mesh.nblocks} blocks / {leaves} leaves, expected "
             f"{AMR_EXPECT['blocks']} / {AMR_EXPECT['leaves']}")
    load_s = {}
    for name in NAMES:
        t0 = time.perf_counter()
        mesh.load_data([name])
        torch.cuda.synchronize()
        load_s[name] = time.perf_counter() - t0
        if mesh._data[name].device.type != "cuda" or mesh._data[name].dtype != torch.float32:
            fail(f"{name} was not read onto the card as float32")
    say(f"phase 6 HDF5->card seconds per field: {load_s}")
    return model, {"synthesis_and_write_s": synth_s, "hdf5_to_card_s": load_s}


# ---------------------------------------------------------------------------
# Phase 7: K5-K7 against their plain versions at the AMR path's shapes


def phase_amr_kernels(torch, np, mesh):
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import profiles
    from fava_tpu_torch.ops.regrid import RegridPlan

    geom = mesh._profile_geometry(0)
    leaf = profiles._leaf_fields(mesh._profile_fields(), geom)
    nb, ncx, ncy, ncz = leaf[0].shape
    rows = {}

    def as_rows(t):  # (nB, ncx, ncy, ncz) -> (nB*ncx, ncy, ncz): one x row per volume row
        return t.reshape(nb * ncx, ncy, ncz)

    def record(name, got, ref, mag, kernel_fn, plain_fn, work):
        max_abs = float((got - ref).abs().max())
        ratio = float(((got - ref).abs() / (TOL_MOMENTS * mag).clamp(min=1e-300)).max())
        rows[name] = kernel_row(torch, 7, name, max_abs, ratio, TOL_MOMENTS, kernel_fn, plain_fn,
                                work)

    ncell, nrow = leaf[0].numel(), nb * ncx

    f64 = [f.double() for f in leaf]
    got = ck.block_row_moments(*leaf)
    torch.cuda.synchronize()
    ref = ck._block_row_moments_plain(*f64)
    mag = ck._block_row_moments_plain(*(f.abs() for f in f64))
    record("block_row_moments", got, ref, mag, lambda: ck.block_row_moments(*leaf),
           lambda: ck._block_row_moments_plain(*leaf), (16 * ncell + 8 * ck.NRAW * nrow, 10 * ncell))

    means = (ref[1:4] / (ncy * ncz)).contiguous()
    got = ck.block_centered_row_moments(*leaf, means)
    torch.cuda.synchronize()
    ref = ck._block_centered_plain(*f64, means)
    cabs = [as_rows((v - m[..., None, None]).abs()) for v, m in zip(f64[1:], means)]
    amom = ck._row_moments_plain(as_rows(f64[0]), *cabs)
    del cabs
    mag = torch.cat([amom[7:13], amom[4:7]]).reshape(9, nb, ncx)
    record("block_centered_row_moments", got, ref, mag,
           lambda: ck.block_centered_row_moments(*leaf, means),
           lambda: ck._block_centered_plain(*leaf, means),
           (16 * ncell + 8 * (3 + ck.NCEN) * nrow, 21 * ncell))
    del f64, amom, mag, ref, got, leaf
    torch.cuda.empty_cache()

    # K7 on the full-domain regrid of the density (scales 1-16): exact.
    plan = RegridPlan(
        block_bounds=mesh.block_bounds, node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level), ncells_vec=mesh.nCellsVec,
        nblks_vec=mesh.nBlksVec, ndim=mesh.ndim,
    )
    scales = plan.block_scales[plan.source_ids]
    args = (*plan.device_tables(mesh._data["dens"].device), plan.out_shape,
            tuple(plan.out_origin), tuple(plan.ncells_vec))
    stacks = [mesh._data["dens"]]
    got = ck.regrid_fields(stacks, *args)[0]
    torch.cuda.synchronize()
    ref = ck._regrid_plain(stacks, *args)[0]
    exact = torch.equal(got, ref)
    say(f"phase 7 regrid_fields full domain: shape {tuple(got.shape)}, scales "
        f"{int(scales.min())}-{int(scales.max())}, equal to the plain regrid: {exact}")
    if tuple(got.shape) != AMR_EXPECT["full"] or not exact:
        fail("the full-domain regrid disagrees with its plain version")
    del got, ref
    full = {"ms": cuda_ms(torch, lambda: ck.regrid_fields(stacks, *args), 10),
            "plain_ms": cuda_ms(torch, lambda: ck._regrid_plain(stacks, *args), 3),
            **least_time(regrid_bytes(torch, ck, stacks, args), 0)}
    say(f"phase 7 regrid_fields full domain, dens only: {full}")
    regrid_launch(torch, ck, 7, AMR_EXPECT["full"],
                  ck._regrid_wide(args[3], args[4], args[5], tuple(args[0].shape[1:])))
    torch.cuda.empty_cache()
    return rows, full


def regrid_bytes(torch, ck, stacks, args):
    """Bytes a regrid must move: each output cell written once and each
    source cell that some output cell takes read once, per field."""
    leaf_table, offsets, scales, out_shape, origin, ncells = args
    flat, valid = ck._regrid_flat_plain(leaf_table, offsets, scales, out_shape, origin, ncells,
                                        tuple(stacks[0].shape[1:]))
    used = torch.zeros(stacks[0].numel(), dtype=torch.bool, device=flat.device)
    used[flat[valid]] = True
    nsrc = int(used.sum())
    del flat, valid, used
    return len(stacks) * 4 * (nsrc + math.prod(out_shape))


# ---------------------------------------------------------------------------
# Phase 8: the AMR path


def counted(torch, ck, what, fn, expect, phase=8):
    """fn() with the launch counters reset before and read after; fails
    unless every kernel in ``expect`` was launched."""
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    say(f"phase {phase} {what} launches: {({k: v for k, v in launches.items() if v})}")
    missing = [k for k in expect if launches[k] == 0]
    if missing:
        fail(f"{what} never launched {missing}")
    return out, launches


def compare_profiles(np, got, ref, vmax, dmax, what, phase=8):
    """max |diff| / scale of every profile array, floored as phase 4: by
    the velocity scale for velocities, by dmax*vmax^2 for stresses."""
    errs = {}

    def walk(g, r, key):
        if isinstance(r, (dict, tuple)):
            for k in (r if isinstance(r, dict) else range(len(r))):
                walk(g[k], r[k], f"{key}/{k}")
            return
        g, r = np.asarray(g), np.asarray(r)
        if g.shape != r.shape or not np.isfinite(g).all():
            fail(f"{what} {key}: shape {g.shape} vs {r.shape}, or not finite")
        floor = dmax * vmax**2 if "/R" in key else (vmax if "vel" in key else 0.0)
        scale = max(float(np.abs(r).max()), floor)
        errs[key] = float(np.abs(g - r).max() / scale) if scale > 0 else 0.0

    walk(got, ref, what)
    worst = max(errs.values())
    say(f"phase {phase} {what} vs its reference: max |diff|/scale {worst!r} over "
        f"{len(errs)} arrays (bound {TOL_PROFILES!r})")
    if not worst <= TOL_PROFILES:
        fail(f"{what} disagrees with its reference: {errs}")
    return worst


def amr_stage_ms(torch, mesh):
    """Device ms of the leaf gather, K5 and K6 of one reynolds_stress
    (CUDA events between the stages)."""
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import profiles

    data, geom = mesh._profile_fields(), mesh._profile_geometry(0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    leaf = profiles._leaf_fields(data, geom)
    ev[1].record()
    raw = ck.block_row_moments(*leaf)
    ev[2].record()
    row_cells = leaf[0].shape[2] * leaf[0].shape[3]
    ck.block_centered_row_moments(*leaf, (raw[1:4] / row_cells).contiguous())
    ev[3].record()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(("leaf_gather", "K5", "K6"))}


def phase_amr_path(torch, np, model, workdir: Path):
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops.regrid import RegridPlan

    mesh = model.mesh
    totals = dict.fromkeys(AMR_KERNELS, 0)
    rs, n = counted(torch, ck, "reynolds_stress", model.reynolds_stress, AMR_KERNELS[:2])
    fav, n2 = counted(torch, ck, "favre_profiles", model.favre_profiles, AMR_KERNELS[:2])
    for k in AMR_KERNELS:
        totals[k] += n[k] + n2[k]
    if rs[1]["Rxx"].shape != (AMR_EXPECT["full"][0],):
        fail(f"x-profiles have {rs[1]['Rxx'].shape} bins, expected {AMR_EXPECT['full'][0]}")
    times = {"reynolds_stress_wall_s": wall_per_call(torch, model.reynolds_stress, 3)}
    amr_stage_ms(torch, mesh)
    stages = amr_stage_ms(torch, mesh)
    stages["scatter_and_assembly"] = (
        1e3 * statistics.median(times["reynolds_stress_wall_s"]) - sum(stages.values())
    )
    times["reynolds_stress_stage_ms"] = stages

    # Stage 4 on the leaves, before from_amr collapses the mesh to the window.
    amr_results, pdf2d_row, times["stage4_wall_s"], stage4_launches = amr_stage4(
        torch, np, ck, model)

    window = np.array(AMR_WINDOW)
    stacks = [mesh._field_stack(k) for k in NAMES]
    plan = RegridPlan(
        block_bounds=mesh.block_bounds, node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level), ncells_vec=mesh.nCellsVec,
        nblks_vec=mesh.nBlksVec, ndim=mesh.ndim, subdomain_coords=window,
    )
    uni_path = workdir / "rt_hdf5_uniform_0001"
    t0 = time.perf_counter()
    _, n = counted(torch, ck, "from_amr", lambda: mesh.from_amr(
        subdomain_coords=window, fields=list(NAMES), filename=uni_path), AMR_KERNELS[2:])
    times["from_amr_with_write_s"] = time.perf_counter() - t0
    totals["regrid_fields"] += n["regrid_fields"]
    regridded = [mesh._data[k] for k in NAMES]
    if tuple(regridded[0].shape) != AMR_EXPECT["window"]:
        fail(f"window regridded to {tuple(regridded[0].shape)}")
    tables = (*plan.device_tables(regridded[0].device), plan.out_shape,
              tuple(plan.out_origin), tuple(plan.ncells_vec))
    twin = ck._regrid_plain(stacks, *tables)
    max_abs = max(float((r - t).abs().max()) for r, t in zip(regridded, twin))
    if not all(torch.equal(r, t) for r, t in zip(regridded, twin)):
        fail(f"the regridded window differs from the plain regrid (max |diff| {max_abs!r})")
    del twin
    window_ms = {"max_abs_err": max_abs,
                 "ms": cuda_ms(torch, lambda: ck.regrid_fields(stacks, *tables), 10),
                 "plain_ms": cuda_ms(torch, lambda: ck._regrid_plain(stacks, *tables), 3),
                 **least_time(regrid_bytes(torch, ck, stacks, tables), 0), "library_ms": None}
    say(f"phase 8 from_amr window {AMR_WINDOW} -> {AMR_EXPECT['window']}: equal to the plain "
        f"regrid; K7 (4 fields) {window_ms}")
    del stacks, model
    torch.cuda.empty_cache()
    extra = workdir / "rt_hdf5_uniform_0002"
    t0 = time.perf_counter()
    mesh.save(extra, names=list(NAMES))
    times["uniform_write_s"] = time.perf_counter() - t0
    extra.unlink()

    t0 = time.perf_counter()
    uni = fava_tpu_torch.FLASH(workdir)
    uni.load(file_type="uni", fields=list(NAMES))
    torch.cuda.synchronize()
    times["uniform_read_back_s"] = time.perf_counter() - t0
    if not all(torch.equal(uni.mesh.data(k), r) for k, r in zip(NAMES, regridded)):
        fail("the uniform file read back differs from the regridded tensors")
    say(f"phase 8 uniform file {uni_path.stat().st_size / 1e9:.3f} GB read back: equal to the "
        "regridded tensors")
    del regridded, mesh
    torch.cuda.empty_cache()

    out, _ = counted(torch, ck, "window flagship_analysis", uni.flagship_analysis, FLAGSHIP_KERNELS)
    check_outputs(np, out, AMR_EXPECT["window"], "single")
    say("phase 8 window flagship outputs: finite, expected shapes, static counts")
    times["window_flagship_analysis_s"] = wall_per_call(torch, uni.flagship_analysis, 3)
    del uni
    torch.cuda.empty_cache()

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = fava_tpu_torch.FLASH(workdir, device="cpu")
    cpu.load(file_type="plt")
    rs_ref, fav_ref = cpu.reynolds_stress(), cpu.favre_profiles()
    vmax = max(float(cpu.mesh.data(k).abs().max()) for k in NAMES[1:])
    dmax = float(cpu.mesh.data("dens").abs().max())
    say(f"phase 8 plain float64 profiles on the CPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    amr_ref = {name: fn() for name, (fn, _) in amr_stage4_runs(cpu).items()}
    wmax = float(np.max(cpu.mesh.get_cell_volumes("LEAF")))
    say(f"phase 10 plain float64 AMR stage 4 on the CPU: {time.perf_counter() - t0:.1f} s")
    del cpu
    times["profile_errors"] = {
        "reynolds_stress": compare_profiles(np, rs[1:], rs_ref[1:], vmax, dmax, "reynolds_stress"),
        "favre_profiles": compare_profiles(np, fav, fav_ref, vmax, dmax, "favre_profiles"),
    }
    times["stage4_errors"] = compare_stage4(
        np, amr_results, amr_ref, AMR_WEIGHTED, wmax, "AMR stage 4", 10)
    return totals, window_ms, times, pdf2d_row, stage4_launches


# ---------------------------------------------------------------------------
# Phases 10-12: stage 4 (spectra, histograms, sums) on the AMR leaves and
# the window, and the odd-extent window


def add_counts(totals, launches):
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def pdf2d_against_plain(torch, np, ck, x, y, w):
    """The pdf2d kernel and its plain version on the samples and the
    default edges (100 x 100 over the data ranges): (x edges, y edges, the
    kernel's result, the plain one, error/bound: counts exact, weighted
    sums within TOL_WSUM per bin)."""
    xe = np.linspace(float(x.min()), float(x.max()), 101)
    ye = np.linspace(float(y.min()), float(y.max()), 101)
    got = ck.pdf2d_counts(x, y, xe, ye, weights=w)
    torch.cuda.synchronize()
    ref = ck._pdf2d_plain(x, y, xe, ye, w)
    if w is None:
        ratio = 0.0 if torch.equal(got, ref) else float("inf")
    else:
        ratio = float(((got - ref).abs() / (TOL_WSUM * ref.abs()).clamp(min=1e-300)).max())
    return xe, ye, got, ref, ratio


def check_pdf2d_kernel(torch, np, ck, phase, x, y, w):
    """The pdf2d kernel against its plain version on the path's samples,
    run to run, and timed beside it (the kernels line's row)."""
    name = "pdf2d_counts" if w is None else "pdf2d_weighted"
    xe, ye, got, ref, ratio = pdf2d_against_plain(torch, np, ck, x, y, w)
    again = ck.pdf2d_counts(x, y, xe, ye, weights=w)
    shared = ck.pdf2d_hist_in_shared_memory(100, 100, w is not None, x.device)
    say(f"phase {phase} {name}: {x.numel()} samples, 100 x 100 bins, histogram in shared "
        f"memory {shared}, run-to-run max |diff| {float((got - again).abs().max())!r}")
    return name, kernel_row(torch, phase, name, float((got - ref).abs().max()), ratio,
                            "exact" if w is None else TOL_WSUM,
                            lambda: ck.pdf2d_counts(x, y, xe, ye, weights=w),
                            lambda: ck._pdf2d_plain(x, y, xe, ye, w),
                            pdf2d_work(x.numel(), w is not None))


def pdf2d_work(n, weighted):
    """(bytes, operations) of a pdf2d call on n samples and 100 x 100 bins:
    the samples (and weights) read once, the output written once."""
    return 4 * (3 if weighted else 2) * n + 8 * 100 * 100, 8 * n


def pdf2d_launch_report(torch, ck, phase, n):
    """Print B8's ptxas report and its launch on n samples: threads and
    dynamic shared bytes a block, blocks an SM (occupancy) and the grid."""
    for line in ptxas_report("pdf2d_kernel", entries=True):
        say(f"phase {phase} pdf2d_kernel ptxas: {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for weighted in (False, True):
        launch = ck.pdf2d_launch(n, 100, 100, weighted)
        bps = launch["blocks_per_sm"]
        say(f"phase {phase} pdf2d_kernel<{'weighted' if weighted else 'counted'}> launch on {n} samples, "
            f"100 x 100 bins: {ck.PDF2D_THREADS} threads and {launch['smem']} shared bytes a block "
            f"(histogram in shared memory {bool(launch['shared'])}), {bps} blocks an SM "
            f"({bps * ck.PDF2D_THREADS // 32} warps of 64), grid {launch['blocks']} on {sms} SMs")


def pdf2d_beside(torch, np, ck, phase, label, x, y, w):
    """A pdf2d kernel on samples beside its path's: held to its plain
    version as check_pdf2d_kernel holds it, timed, against its bound."""
    name = "pdf2d_counts" if w is None else "pdf2d_weighted"
    xe, ye, _, _, ratio = pdf2d_against_plain(torch, np, ck, x, y, w)
    if not ratio <= 1.0:
        fail(f"{name} on {label} disagrees with its plain version (error/bound {ratio!r})")
    ms = cuda_ms(torch, lambda: ck.pdf2d_counts(x, y, xe, ye, weights=w), 20)
    bound = least_time(*pdf2d_work(x.numel(), w is not None))["bound_ms"]
    say(f"phase {phase} {name} on {label} ({x.numel()} samples): error/bound {ratio!r}, {ms!r} ms "
        f"against its bound {bound!r} ms ({ms / bound!r}x)")


def pdf2d_uncorrelated(torch, np, ck, phase, n=134217728):
    """Both pdf2d kernels on n uncorrelated uniform samples (no runs)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    x, y, w = (torch.rand(n, device="cuda", generator=g) for _ in range(3))
    for weights in (None, w):
        pdf2d_beside(torch, np, ck, phase, "uncorrelated uniform samples", x, y, weights)
    del x, y, w
    torch.cuda.empty_cache()


# AMR analyses whose histograms are weighted (by leaf cell volume): their
# defaults, weight="volume"; binned_statistic counts stay raw sample counts.
AMR_WEIGHTED = {"pdf2d volume", "pdf1d", "density pdf"}


def amr_stage4_runs(model):
    """The stage-4 analyses of the AMR leaves and the kernels each must launch."""
    return {
        "pdf2d volume": (lambda: model.pdf2d("dens", "velx"), ("pdf2d_weighted",)),
        "pdf2d unweighted": (lambda: model.pdf2d("dens", "velx", weight=None), ("pdf2d_counts",)),
        "pdf1d": (lambda: model.pdf1d("velx"), ()),
        "density pdf": (model.density_pdf, ()),
        "binned statistic": (lambda: model.binned_statistic("dens", "velx"), ()),
        "mass sum": (model.mass_sum, ()),
        "volume average": (lambda: model.volume_average("dens"), ()),
    }


def run_counted(torch, ck, phase, runs, prefix):
    """Each analysis once with counters (checked), then its warm wall."""
    results, walls, totals = {}, {}, {}
    for name, (fn, expect) in runs.items():
        results[name], launches = counted(torch, ck, f"{prefix} {name}", fn, expect, phase)
        add_counts(totals, launches)
        walls[name] = wall_per_call(torch, fn, 3)
    say(f"phase {phase} {prefix} warm walls (s): {json.dumps(walls)}")
    return results, walls, totals


def amr_stage4(torch, np, ck, model):
    """Phase 10 on the card: the weighted pdf2d kernel on the leaf samples,
    then the AMR stage-4 analyses with counters."""
    mesh = model.mesh
    dens, velx = mesh._leaf_stack("dens"), mesh._leaf_stack("velx")
    w = mesh._pdf_weights("volume", tuple(dens.shape))
    pdf2d_launch_report(torch, ck, 10, dens.numel())
    row = check_pdf2d_kernel(torch, np, ck, 10, dens, velx, w)
    pdf2d_beside(torch, np, ck, 10, "the AMR leaves", dens, velx, None)
    del dens, velx, w
    torch.cuda.empty_cache()
    results, walls, totals = run_counted(torch, ck, 10, amr_stage4_runs(model), "AMR")
    return results, row, walls, totals


def compare_stage4(np, got, ref, weighted, wmax, what, phase):
    """Hold stage-4 results to the plain float64 path: histogram counts
    exact (the weighted histograms of the analyses named in ``weighted``
    within TOL_WSUM per bin), density_pdf's within TOL_SHIFT moved samples
    of weight <= wmax, spectra within TOL_SPECTRA of scale, everything
    else within TOL_SUMS of max(|ref|, 1)."""
    worst = {}

    def walk(g, r, key):
        if isinstance(r, dict):
            if sorted(g) != sorted(r):
                fail(f"{what} {key}: keys {sorted(g)} vs {sorted(r)}")
            for k in r:
                walk(g[k], r[k], f"{key}/{k}")
            return
        g, r = np.asarray(g, dtype=np.float64), np.asarray(r, dtype=np.float64)
        if g.shape != r.shape or not np.array_equal(np.isnan(g), np.isnan(r)):
            fail(f"{what} {key}: shape {g.shape} vs {r.shape}, or NaN in other places")
        g, r = g[~np.isnan(r)], r[~np.isnan(r)]
        analysis, leaf = key.split("/")[1], key.rsplit("/", 1)[-1]
        diff = np.abs(g - r)
        if "density pdf" in key and leaf in ("counts", "pdf"):
            if leaf == "pdf":
                return  # counts / (total * width): held through the counts
            moved = float(np.maximum(diff - TOL_WSUM * np.abs(r), 0.0).sum())
            worst[key] = moved / (2 * TOL_SHIFT * wmax)  # a moved sample changes two bins
        elif leaf == "weight_sums" or (leaf in ("counts", "pdf") and analysis in weighted):
            worst[key] = float((diff / (TOL_WSUM * np.abs(r)).clip(min=1e-300)).max(initial=0.0))
        elif leaf in ("counts", "pdf", "k") or (leaf in ("edges", "xedges", "yedges", "centers")
                                               and "density pdf" not in key):
            worst[key] = 0.0 if np.array_equal(g, r) else float("inf")
        elif leaf in ("total", "longitudinal", "transverse", "power") and "spectra" in key:
            worst[key] = float(diff.max(initial=0.0) / np.abs(r).max() / TOL_SPECTRA)
        else:
            worst[key] = float(diff.max(initial=0.0) / max(np.abs(r).max(initial=0.0), 1.0) / TOL_SUMS)

    walk(got, ref, "")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what} vs the plain float64 path: {len(worst)} arrays, worst "
        f"error/bound {worst[top]!r} ({top})")
    if bad:
        fail(f"{what} disagrees with the plain float64 path (error/bound): {bad}")
    return worst[top]


def check_anl_file(np, path, results):
    """The analysis file read back (h5lite) equals the results written."""
    from fava_tpu_torch.io import h5lite

    with h5lite.File(path) as f:
        def walk(node, r, key):
            if isinstance(r, dict):
                for k in r:
                    walk(node[k], r[k], f"{key}/{k}")
                return
            a, b = node[()], np.asarray(r)
            if a.shape != b.shape or not np.array_equal(a, b, equal_nan=b.dtype.kind == "f"):
                fail(f"analysis file {key} differs from the result written")

        for name, res in results.items():
            walk(f[name], res, name)


def window_stage4_runs(model):
    """The stage-4 analyses of the window and the kernels each must launch."""
    return {
        "kinetic energy spectra": (model.kinetic_energy_spectra, ("shell_bin_powers_fused",)),
        "scalar spectra": (lambda: model.scalar_spectra("dens"),
                           ("fold_quadrants_pair", "shell_bin_values_folded_1ch")),
        "pdf1d": (lambda: model.pdf1d("velx"), ()),
        "pdf2d": (lambda: model.pdf2d("dens", "velx"), ("pdf2d_counts",)),
        "pdf2d mass": (lambda: model.pdf2d("dens", "velx", weight="mass"), ("pdf2d_weighted",)),
        "density pdf": (model.density_pdf, ()),
        "binned statistic": (lambda: model.binned_statistic("dens", "velx"), ()),
        "mass sum": (model.mass_sum, ()),
        "mass fraction": (model.mesh.mass_fraction, ()),
    }


def phase_window_stage4(torch, np, workdir: Path):
    """Phase 11: stage 4 on the 512^3 window read back from its file."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck

    uni = fava_tpu_torch.FLASH(workdir)
    uni.load(file_type="uni", fields=list(NAMES))
    dens, velx = uni.mesh.data("dens"), uni.mesh.data("velx")
    rows = dict([check_pdf2d_kernel(torch, np, ck, 11, dens, velx, None)])
    pdf2d_beside(torch, np, ck, 11, "the window, mass weights", dens, velx, dens)
    pdf2d_uncorrelated(torch, np, ck, 11)

    # Single-channel K4 on the folded dens power (the scalar spectrum's).
    nx, ny, nz = dens.shape
    nbins = max(nx, ny, nz) // 2 - 1
    fw = torch.fft.rfftn(dens, norm="forward")
    p = (fw.real.square() + fw.imag.square()).contiguous()
    del fw
    folded, _ = ck.fold_quadrants_pair(p, p)
    del p
    got = ck.shell_bin_values_folded_1ch(folded, nbins, ny, nz)
    inside = inside_cells(ck, folded, nbins, full_ny=ny)
    torch.cuda.synchronize()
    ref = ck._shell_bin_folded_plain(folded.double(), None, nbins, ny, nz)[0]
    rows["shell_bin_values_folded_1ch"] = kernel_row(
        torch, 11, "shell_bin_values_folded_1ch", float((got - ref).abs().max()),
        float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max()), TOL_BIN,
        lambda: ck.shell_bin_values_folded_1ch(folded, nbins, ny, nz),
        lambda: ck._shell_bin_folded_plain(folded, None, nbins, ny, nz),
        (4 * inside + 8 * nbins, 6 * inside))
    nxh, nyh, nzr = folded.shape
    walk_report(torch, ck, 11, "shell_bin_values_folded_1ch", rows["shell_bin_values_folded_1ch"],
                ck.walk_launch("fava_shell_bin_folded_blocks_per_sm", (1, 0), 1, nxh * nyh, nbins),
                "fava_shell_bin_values_folded", folded.data_ptr(), None, got.data_ptr(), nxh, nyh, nzr,
                nbins, ny, nz, 1)
    del folded, dens, velx
    torch.cuda.empty_cache()

    results, walls, totals = run_counted(torch, ck, 11, window_stage4_runs(uni), "window")
    anl = workdir / "rt_hdf5_analysis_0001"
    t0 = time.perf_counter()
    for name, res in results.items():  # one call per analysis, as pipeline stage 4 writes
        uni.save_to_hdf5({name: res}, anl)
    walls["analysis_file_write_s"] = time.perf_counter() - t0
    check_anl_file(np, anl, results)
    say(f"phase 11 analysis file {anl.name}: {len(results)} results written in "
        f"{walls['analysis_file_write_s']!r} s and read back equal")

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = fava_tpu_torch.FLASH(workdir, device="cpu")
    cpu.load(file_type="uni", fields=list(NAMES))
    ref = {name: fn() for name, (fn, _) in window_stage4_runs(cpu).items()}
    say(f"phase 11 plain float64 window stage 4 on the CPU: {time.perf_counter() - t0:.1f} s")
    walls["errors"] = compare_stage4(np, results, ref, {"pdf2d mass"}, 1.0, "window stage 4", 11)
    return uni, cpu, rows, walls, totals


def phase_odd_extents(torch, np, uni, cpu):
    """Phase 12: the window cut to 511 x 512 x 512 bins through B10."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck

    cut = [uni.mesh.data(k)[: N - 1].contiguous() for k in NAMES]
    nx, ny, nz = cut[0].shape
    nbins = max(nx, ny, nz) // 2 - 1
    total, longi = path_powers(torch, cut)
    got = ck.shell_bin_sums_unfolded(total, longi, nbins, nz)
    again = ck.shell_bin_sums_unfolded(total, longi, nbins, nz)
    inside = inside_cells(ck, total, nbins, full_nz=nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_unfolded_plain(total.double(), longi.double(), nbins, nz)
    ones = torch.ones(total.shape, dtype=torch.float64, device=total.device)
    plain_counts = ck._shell_bin_unfolded_plain(ones, None, nbins, nz)[0]
    del ones
    if not torch.equal(ck._static_counts(total.shape, nbins, nz, total.device), plain_counts):
        fail("the static shell counts differ from the plain binning of ones")
    say(f"phase 12 shell_bin_sums_unfolded on {tuple(total.shape)}: static counts equal to the "
        f"plain binning of ones; run-to-run max |diff| {float((got - again).abs().max())!r}")
    rows = {"shell_bin_sums_unfolded": kernel_row(
        torch, 12, "shell_bin_sums_unfolded", float((got - ref).abs().max()),
        float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max()), TOL_BIN,
        lambda: ck.shell_bin_sums_unfolded(total, longi, nbins, nz),
        lambda: ck._shell_bin_unfolded_plain(total, longi, nbins, nz),
        (8 * inside + 16 * nbins, 8 * inside))}
    walk_report(torch, ck, 12, "shell_bin_sums_unfolded", rows["shell_bin_sums_unfolded"],
                unfolded_launch(torch, ck, total.shape, nz, 2, nbins), "fava_shell_bin_sums_unfolded",
                total.data_ptr(), longi.data_ptr(), got.data_ptr(), nx, ny, nz // 2 + 1, nbins, nz, 2)
    del total, longi, got, again, ref
    torch.cuda.empty_cache()

    odd = fava_tpu_torch.from_arrays(dict(zip(NAMES, cut)))
    unfolded = ("shell_bin_sums_unfolded",)
    runs = {
        "kinetic energy spectra": (odd.kinetic_energy_spectra, unfolded),
        "scalar spectra": (lambda: odd.scalar_spectra("dens"), unfolded),
        "flagship analysis": (odd.flagship_analysis,
                              ("row_moments", "centered_row_moments", *unfolded)),
    }
    results, walls, totals = run_counted(torch, ck, 12, runs, "511x512x512")
    if totals.get("fold_quadrants_pair", 0) or totals.get("shell_bin_values_folded", 0):
        fail(f"the odd-extent path reached the folded binning: {totals}")
    check_outputs(np, results["flagship analysis"], (nx, ny, nz), "single")

    t0 = time.perf_counter()
    cut_cpu = [cpu.mesh.data(k)[: N - 1].contiguous() for k in NAMES]
    odd_cpu = fava_tpu_torch.from_arrays(dict(zip(NAMES, cut_cpu)), device="cpu")
    ref = {"kinetic energy spectra": odd_cpu.kinetic_energy_spectra(),
           "scalar spectra": odd_cpu.scalar_spectra("dens")}
    flag_ref = odd_cpu.flagship_analysis()
    say(f"phase 12 plain float64 odd-extent path on the CPU: {time.perf_counter() - t0:.1f} s")
    walls["errors"] = compare_stage4(
        np, {k: results[k] for k in ref}, ref, set(), 1.0, "511x512x512 spectra", 12)
    walls["flagship_errors"] = compare_flagship(
        np, results["flagship analysis"], flag_ref, cut_cpu, "511x512x512 flagship", 12)
    return rows, walls, totals


# ---------------------------------------------------------------------------
# Phases 13-15: the out-of-core flagship step, its chunk binning (B6) at
# 1024^3, and a 1280^3 volume beyond the in-core step


N_STREAM = 1024
N_BEYOND = 1280
SLAB_ROWS = 64
CHUNK_ROWS = 128
CHUNK_KX0 = (0, 448, 896)
STREAM_KERNELS = ("shell_bin_values_rfft_chunk", "block_row_moments", "block_centered_row_moments")


def host_loader(hosts):
    """Slab loader over host arrays (the fields of a volume the card
    cannot hold with its step)."""
    def loader(name, x0, x1):
        return hosts[name][x0:x1]

    return loader


def phase_chunk_kernel(torch, fields):
    """Phase 13: B6 against its plain version on the 1024^3 chunk shapes
    (128, 1024, 513) of the path's power volumes at kx0 = 0, 448 and 896,
    and on a chunk of an odd-nx (1023) volume; the chunks of one snapshot
    add up to B10 on the whole volume."""
    from fava_tpu_torch.ops import cuda_kernels as ck

    nx, ny, nz = (int(s) for s in fields[0].shape)
    nbins = max(nx, ny, nz) // 2 - 1
    total, longi = path_powers(torch, fields)
    worst, max_abs = 0.0, 0.0
    for full_nx, kx0 in [(nx, k) for k in CHUNK_KX0] + [(nx - 1, CHUNK_KX0[1])]:
        t, lo = total[kx0 : kx0 + CHUNK_ROWS], longi[kx0 : kx0 + CHUNK_ROWS]
        got = ck.shell_bin_values_rfft_chunk(t, lo, nbins, full_nx, nz, kx0)
        torch.cuda.synchronize()
        ref = ck._shell_bin_unfolded_plain(t.double(), lo.double(), nbins, nz, kx0, full_nx)
        err = (got[:2] - ref).abs()
        ratio = float((err / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
        say(f"phase 13 chunk {tuple(t.shape)} of nx {full_nx} at kx0 {kx0}: max_abs_err "
            f"{float(err.max())!r}, error/bound {ratio!r}")
        worst, max_abs = max(worst, ratio), max(max_abs, float(err.max()))
    starts = range(0, nx, CHUNK_ROWS)
    acc = sum(ck.shell_bin_values_rfft_chunk(total[k : k + CHUNK_ROWS], longi[k : k + CHUNK_ROWS],
                                             nbins, nx, nz, k) for k in starts)
    whole = ck.shell_bin_sums_unfolded(total, longi, nbins, nz)
    ratio = float(((acc[:2] - whole).abs() / (TOL_BIN * whole.abs()).clamp(min=1e-300)).max())
    say(f"phase 13 {len(starts)} chunks vs B10 on the whole {tuple(total.shape)}: error/bound "
        f"{ratio!r} (bound {TOL_BIN!r})")
    if not ratio <= 1.0:
        fail("the chunk binning does not add up to the whole-volume binning")

    def one_snapshot():
        for k in starts:
            ck.shell_bin_values_rfft_chunk(total[k : k + CHUNK_ROWS], longi[k : k + CHUNK_ROWS],
                                           nbins, nx, nz, k)

    inside_all = inside_cells(ck, total, nbins, full_nz=nz)
    say(f"phase 13 {len(starts)} launches (one {nx}^3 snapshot): {cuda_ms(torch, one_snapshot, 5)!r} ms "
        f"against {least_time(8 * inside_all + 16 * nbins * len(starts), 8 * inside_all)}")
    t, lo = total[:CHUNK_ROWS], longi[:CHUNK_ROWS]  # the chunk with the most cells inside
    inside = inside_cells(ck, t, nbins, full_nz=nz, kx0=0, full_nx=nx)
    row = kernel_row(torch, 13, "shell_bin_values_rfft_chunk", max_abs, worst, TOL_BIN,
                     lambda: ck.shell_bin_values_rfft_chunk(t, lo, nbins, nx, nz, 0),
                     lambda: ck._shell_bin_unfolded_plain(t, lo, nbins, nz, 0, nx),
                     (8 * inside + 16 * nbins, 8 * inside))
    sums2 = torch.zeros((2, nbins), dtype=torch.float64, device=t.device)
    walk_report(torch, ck, 13, "shell_bin_values_rfft_chunk", row,
                unfolded_launch(torch, ck, tuple(t.shape), nz, 2, nbins),
                "fava_shell_bin_sums_rfft_chunk", t.data_ptr(), lo.data_ptr(), sums2.data_ptr(),
                CHUNK_ROWS, ny, nz // 2 + 1, nbins, nx, nz, 0, 2)
    del total, longi, t, lo, acc, whole
    torch.cuda.empty_cache()
    return row


def main_vs_fused_ms(torch, fields, reps=3):
    """Phase 13 on the 1024^3 fields: phase 18's paths (a) (the power
    volumes into K3 and K4) and (m) (the main path's spectra: cuFFT into
    one stack, B9), warm device ms per call (CUDA events); counts equal
    and sums within TOL_SPECTRA of scale."""
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops.spectra import kinetic_power_volumes, rfft_shell_sums

    dens, *vels = fields
    nbins = max(dens.shape) // 2 - 1
    nz = int(dens.shape[2])
    paths = {"a": lambda: ck.shell_bin_sums_rfft(*kinetic_power_volumes(dens, vels), nbins, nz),
             "m": lambda: rfft_shell_sums(dens, vels, nbins)}
    (ca, sa), (cm, sm) = (run() for run in paths.values())
    err = float((sm - sa).abs().max() / sa.abs().max())
    if not (torch.equal(ca, cm) and err <= TOL_SPECTRA):
        fail(f"at 1024^3 path (m) disagrees with path (a): max|diff|/scale {err!r}")
    del ca, sa, cm, sm
    out = {f"{key}_ms": cuda_ms(torch, run, reps) for key, run in paths.items()}
    out["m_vs_a"] = err
    say(f"phase 13 spectra at 1024^3, (a) power volumes -> K3, K4 vs (m) main path: {out}")
    return out


def streamed_run(torch, np, ck, loader, n, what, phase, **kw):
    """One streamed_uniform_analysis with the counters reset before and
    checked after: B6 once per chunk, K5/K6 once per slab, no K1, K2 or B9."""
    from fava_tpu_torch.ops import outofcore

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = outofcore.streamed_uniform_analysis(loader, (n, n, n), slab_rows=SLAB_ROWS,
                                              chunk_rows=CHUNK_ROWS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()
    say(f"phase {phase} {what}: {wall!r} s, launches {({k: v for k, v in launches.items() if v})}")
    expect = {"shell_bin_values_rfft_chunk": n // CHUNK_ROWS, "block_row_moments": n // SLAB_ROWS,
              "block_centered_row_moments": n // SLAB_ROWS}
    if any(launches[k] != v for k, v in expect.items()) or any(
            launches[k] for k in FLAGSHIP_KERNELS):
        fail(f"{what} launched {launches}, expected {expect} and no in-core kernel")
    check_outputs(np, out, (n, n, n), "single")
    return out, wall, launches


def phase_streamed(torch, np):
    """Phases 13 and 14: make_example_fields(1024) on the card and on the
    host; the in-core step on the card as the reference; B6 checked on
    the path's powers; then the streamed step twice from the host copy
    through a host-memory slab loader, each run held to the reference."""
    from fava_tpu_torch import flagship
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import twopoint

    n = N_STREAM
    fields = flagship.make_example_fields(n)
    floor = output_floors(fields)
    hosts = dict(zip(NAMES, (f.cpu().numpy() for f in fields)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = flagship.uniform_analysis_step(*fields)
    torch.cuda.synchronize()
    times = {"incore_1024_s": time.perf_counter() - t0,
             "incore_1024_peak_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30}
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    t0 = time.perf_counter()
    incore_stats = {"velocity correlations": twopoint.velocity_correlations(*fields[1:])}
    times["incore_1024_velocity_correlations_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    incore_stats["two point lines"], tp_launches = counted(
        torch, ck, f"in-core {n}^3 two point correlation", lambda: twopoint.two_point_correlation(
            fields[0]), ("fold_quadrants_pair", "shell_bin_values_folded_1ch"), 14)
    times["incore_1024_two_point_s"] = time.perf_counter() - t0
    row = phase_chunk_kernel(torch, fields)
    times["spectra_1024_ms"] = main_vs_fused_ms(torch, fields)
    del fields
    torch.cuda.empty_cache()

    totals, walls = dict(tp_launches), []
    for i in range(2):  # a copy/compute race would show as a run that disagrees
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        out, wall, launches = streamed_run(torch, np, ck, host_loader(hosts), n,
                                           f"streamed {n}^3 run {i + 1}", 14, stage_ms=stages)
        walls.append(wall)
        add_counts(totals, launches)
        compare_flagship(np, out, ref, floor, f"streamed {n}^3 run {i + 1} vs in-core", 14)
    times.update({"streamed_1024_s": walls, "streamed_1024_stage_ms": stages,
                  "streamed_1024_peak_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30})
    times["streamed_1024_statistics"] = streamed_lines_vs_incore(torch, np, hosts, incore_stats, n, 14)
    del hosts
    return row, totals, times


def host_memory_gb():
    """(MemTotal, MemAvailable) of the host in GB, from /proc/meminfo."""
    info = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
    return tuple(int(info[k].split()[0]) * 1024 / 1e9 for k in ("MemTotal", "MemAvailable"))


def phase_beyond_incore(torch, np):
    """Phase 15: a 1280^3 volume, which the in-core step cannot hold on an
    80 GB card, streamed from host memory."""
    import resource

    from fava_tpu_torch import flagship
    from fava_tpu_torch.mesh.flash_uniform import streams_out_of_core
    from fava_tpu_torch.ops import cuda_kernels as ck

    n = N_BEYOND
    say(f"phase 15 host memory before (total, available GB): {host_memory_gb()}")
    fields = flagship.make_example_fields(n)
    hosts = dict(zip(NAMES, (f.cpu().numpy() for f in fields)))
    del fields
    torch.cuda.empty_cache()
    d_rows = hosts["dens"].sum(axis=(1, 2), dtype=np.float64)  # float64 host sums
    free, total = torch.cuda.mem_get_info()
    streams = streams_out_of_core((n, n, n), torch.float32, free)
    say(f"phase 15 auto-dispatch for {n}^3 float32 with {free / 1e9:.3f} GB free of "
        f"{total / 1e9:.3f} GB: {'streams' if streams else 'in core'}")
    if not streams:
        fail(f"the auto-dispatch would run {n}^3 in core")
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    out, wall, launches = streamed_run(torch, np, ck, host_loader(hosts), n,
                                       f"streamed {n}^3", 15, stage_ms=stages)
    errs = {}
    for key, ref in (("total_mass", d_rows.sum()), ("mean_dens", d_rows / (n * n))):
        errs[key] = float(np.abs(out[key] - ref).max() / max(np.abs(ref).max(), 1.0))
        say(f"phase 15 {key} vs float64 host sums of dens: max|diff|/max(|ref|, 1) "
            f"{errs[key]!r} (bound {TOL_SUMS!r})")
        if not errs[key] <= TOL_SUMS:
            fail(f"{n}^3 {key} disagrees with the float64 host sums")
    times = {"streamed_1280_s": wall, "streamed_1280_stage_ms": stages,
             "streamed_1280_peak_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30,
             "errors": errs}
    times["streamed_1280_statistics"] = streamed_beyond_incore(torch, np, hosts, n, 15)
    times["host_peak_rss_GB"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    del hosts
    return launches, times


# ---------------------------------------------------------------------------
# Phases 16-17: the streamed entry point and the snapshot-series drivers


def phase_entry_point(torch, np, workdir: Path, cpu):
    """Phase 16: the 512^3 window file through ``flagship_analysis``,
    streamed and then by the auto-dispatch (in core), held to each other
    and to the float64 CPU path; the file's slab read rate."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck

    uni = fava_tpu_torch.FLASH(workdir)
    uni.load(file_type="uni")
    loader = uni.mesh._streamed_loader()
    nx = int(uni.mesh.nxb)

    def read_all():
        return sum(loader(k, x0, x0 + SLAB_ROWS).nbytes for k in NAMES for x0 in range(0, nx, SLAB_ROWS))

    read_all()  # warm the page cache
    t0 = time.perf_counter()
    nbytes = read_all()
    read_gbps = nbytes / (time.perf_counter() - t0) / 1e9
    say(f"phase 16 x-slab reads of the window file ({SLAB_ROWS} rows, page cache warm): "
        f"{nbytes / 1e9:.3f} GB at {read_gbps!r} GB/s")
    streamed, n1 = counted(torch, ck, "flagship_analysis(streamed=True)", lambda: uni.flagship_analysis(
        streamed=True, slab_rows=SLAB_ROWS, chunk_rows=CHUNK_ROWS), STREAM_KERNELS, 16)
    incore, n2 = counted(torch, ck, "flagship_analysis()", uni.flagship_analysis, FLAGSHIP_KERNELS, 16)
    if any(n1[k] for k in FLAGSHIP_KERNELS) or n2["shell_bin_values_rfft_chunk"]:
        fail("the streamed and the in-core entry points crossed paths")
    say("phase 16 flagship_analysis() ran in core (K1, K2, B9 launched, B6 not)")
    check_outputs(np, streamed, (nx, nx, nx), "single")
    floor = output_floors([uni.mesh.data(k) for k in NAMES])
    walls = {"streamed_s": wall_per_call(torch, lambda: uni.flagship_analysis(
        streamed=True, slab_rows=SLAB_ROWS, chunk_rows=CHUNK_ROWS), 2)}
    t0 = time.perf_counter()
    ref = cpu.flagship_analysis()
    say(f"phase 16 plain float64 flagship path on the CPU: {time.perf_counter() - t0:.1f} s")
    compare_flagship(np, streamed, incore, floor, "streamed vs in-core", 16)
    errs = {what: compare_flagship(np, out, ref, floor, f"{what} vs float64", 16)
            for what, out in (("streamed", streamed), ("in-core", incore))}
    add_counts(n1, n2)
    return n1, {"slab_read_GBps": read_gbps, **walls, "errors": errs}


def phase_series(torch, np, workdir: Path):
    """Phase 17: three more 512^3 uniform files (make_example_fields with
    seeds 1-3, the port's uniform writer) beside the window; the flagship
    series with the auto batch and with batch 3, each snapshot held to
    flagship_analysis on its file; the ingest rate; the Reynolds and Favre
    series over the plt catalog held to the mesh's profiles."""
    import fava_tpu_torch
    from fava_tpu_torch import flagship
    from fava_tpu_torch.analysis import time_series
    from fava_tpu_torch.io import ingest, synthetic
    from fava_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    for seed in (1, 2, 3):
        synthetic.make_uniform_file(
            workdir / f"rt_hdf5_uniform_{seed + 1:04d}", ncells=(N, N, N), time=float(seed),
            field_data=dict(zip(NAMES, flagship.make_example_fields(N, seed=seed))))
    times = {"write_3_files_s": time.perf_counter() - t0}
    model = fava_tpu_torch.FLASH(workdir)
    nsnap = model.nfiles("uni")
    batch = time_series.auto_batch(4 * N**3 * 4, time_series.series_input_budget("cuda"))
    say(f"phase 17 flagship_series over {nsnap} files: auto batch {batch}")
    totals = {}
    series = {}
    for what, kw in (("auto", {}), ("batch 3", {"batch": 3})):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        series[what], n = counted(torch, ck, f"flagship_series {what}",
                                  lambda: model.flagship_series(file_type="uni", **kw),
                                  FLAGSHIP_KERNELS, 17)
        times[f"series_{what}_per_snapshot_s"] = (time.perf_counter() - t0) / nsnap
        times[f"series_{what}_peak_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        if any(n[k] != nsnap for k in FLAGSHIP_KERNELS):
            fail(f"flagship_series {what} launched {n}, expected {nsnap} each")
        add_counts(totals, n)
    for j in range(nsnap):
        model.load(file_type="uni", file_index=j)
        single = model.flagship_analysis()
        floor = output_floors([model.mesh.data(k) for k in NAMES])
        for what, out in series.items():
            compare_flagship(np, {k: v[j] for k, v in out.items()}, single, floor,
                             f"series {what} snapshot {j} vs flagship_analysis", 17,
                             bound_of=lambda key: TOL_BIN)
    model.mesh = None
    torch.cuda.empty_cache()
    paths = [model.uni_files["by index"][j] for j in range(nsnap)]
    times["ingest_GBps"] = ingest.ingest_bandwidth_gbps(paths, NAMES)
    say(f"phase 17 ingest over {nsnap} files (page cache warm: just written and read): "
        f"{times['ingest_GBps']!r} GB/s")

    rs, n = counted(torch, ck, "reynolds_series", lambda: model.reynolds_series(file_type="plt"),
                    AMR_KERNELS[:2], 17)
    add_counts(totals, n)
    fav, n = counted(torch, ck, "favre_series", lambda: model.favre_series(file_type="plt"),
                     AMR_KERNELS[:2], 17)
    add_counts(totals, n)
    model.load(file_type="plt")
    _, stress, means = model.reynolds_stress()
    prof = model.favre_profiles()
    vmax = max(float(model.mesh.data(k).abs().max()) for k in NAMES[1:])
    dmax = float(model.mesh.data("dens").abs().max())
    got_rs = {**{k: rs[k][0] for k in stress}, **{f"mean_{k}": rs[f"mean_{k}"][0] for k in means}}
    ref_rs = {**stress, **{f"mean_{k}": v for k, v in means.items()}}
    got_fav = {"mean_dens": fav["mean_dens"][0],
               **{f"favre_{p}_{k}": fav[f"favre_{p}_{k}"][0] for p in ("mean", "rms")
                  for k in prof["favre_mean"]}}
    ref_fav = {"mean_dens": prof["mean_dens"],
               **{f"favre_{p}_{k}": prof[f"favre_{p}"][k] for p in ("mean", "rms")
                  for k in prof["favre_mean"]}}
    times["reynolds_series_error"] = compare_profiles(np, got_rs, ref_rs, vmax, dmax,
                                                      "reynolds_series", 17)
    times["favre_series_error"] = compare_profiles(np, got_fav, ref_fav, vmax, dmax,
                                                   "favre_series", 17)
    del model
    torch.cuda.empty_cache()
    return totals, times


# ---------------------------------------------------------------------------
# Phase 22: the velocity diagnostics and gradient statistics on the window


def velocity_runs(model):
    """The 11 analyses of the velocity diagnostics and gradient statistics
    through the Model and the launches each must make on an even window:
    {name: (fn, {kernel: launches})}."""
    one_bin = {"fold_quadrants_pair": 1, "shell_bin_values_folded_1ch": 1}
    return {
        "helmholtz decomposition": (model.helmholtz_decomposition, {}),
        "vorticity": (model.vorticity, {}),
        "dilatation": (model.dilatation, {}),
        "enstrophy spectra": (model.enstrophy_spectra, one_bin),
        "helicity spectra": (model.helicity_spectra, one_bin),
        "transfer spectra": (model.transfer_spectra, one_bin),
        "decomposed spectra": (lambda: model.decomposed_kinetic_energy_spectra(weighted=True),
                               {k: 3 for k in one_bin}),
        "anisotropic spectra": (model.anisotropic_kinetic_energy_spectra, {}),
        "turbulence summary": (model.turbulence_summary, {}),
        "velocity gradient statistics": (model.velocity_gradient_statistics, {}),
        "gradient invariant pdfs": (model.gradient_invariant_pdfs, {"pdf2d_counts": 1}),
    }


def run_exact_counts(torch, ck, phase, runs, prefix):
    """Each analysis once with the counters reset before and read after,
    held to its exact launches (no other kernel), then its warm wall (one
    call after a warm one, host clock around synchronized work)."""
    results, walls, totals = {}, {}, {}
    for name, (fn, expect) in runs.items():
        ck.reset_launch_counts()
        results[name] = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        say(f"phase {phase} {prefix} {name} launches: {launches}")
        if launches != expect:
            fail(f"{prefix} {name} launched {launches}, expected {expect}")
        add_counts(totals, launches)
        walls[name] = wall_per_call(torch, fn, 1)[0]
    say(f"phase {phase} {prefix} warm walls (s): {json.dumps(walls)}")
    return results, walls, totals


def signed_scales(torch, ck, vel_ops, vels, lengths):
    """The scales of the signed spectra, from float64 copies of the card's
    fields (on the card). Their shell values are sums of products that
    may cancel to nothing (the helicity of a flow without any), while the
    float32 transforms' rounding scales with the factors: each shell is
    bounded by Cauchy-Schwarz over its modes, |H(k)| <= 2 sqrt(E(k) Z(k))
    (E and Z the shell's energy and enstrophy, as the spectra bin them)
    and |T(k)| <= sqrt(sum |v̂|^2 * sum |adv|^2), adv_i = sum_j k_j
    F[u_i u_j] (transfer_density's factors). The helicity spectrum is held
    to the largest of its shells' bounds, transfer and flux to their sum."""
    shape = tuple(int(s) for s in vels[0].shape)
    nbins, nz, ntot = max(shape) // 2 - 1, shape[2], math.prod(shape)

    def shell_sums(p):
        return ck._shell_bin_unfolded_plain(p, None, nbins, nz)[0]

    v64 = [v.double() for v in vels]
    vh = [torch.fft.rfftn(v) / ntot for v in v64]
    sv = shell_sums(sum(a.real.square() + a.imag.square() for a in vh))
    sw = shell_sums(sum(a.real.square() + a.imag.square()
                        for a in vel_ops._vorticity_hats(vh, shape, lengths)))
    counts = ck._static_counts(vh[0].shape, nbins, nz, sv.device)
    k = torch.arange(nbins, dtype=torch.float64, device=sv.device)
    helicity = float((torch.sqrt(sv * sw) / counts * k * k).max()) * 4.0 * math.pi
    ks = vel_ops._k_grids(shape, torch.float64, sv.device, lengths, True)
    sa = 0.0
    for i in range(3):
        adv = sum(ks[j] * torch.fft.rfftn(v64[i] * v64[j]) / ntot for j in range(3))
        sa = sa + shell_sums(adv.real.square() + adv.imag.square())
    del adv, vh
    return {"helicity spectra": helicity, "transfer spectra": float(torch.sqrt(sv * sa).sum())}


def check_signed_binning(torch, ck, p, nz, phase, what):
    """The scalar shell binning of the signed density ``p`` (K3 + B4 for
    even x and y, else B10) against the plain versions on the same float32
    values in float64 (on the card): each shell within TOL_SIGNED_FOLD +
    TOL_BIN (B10: TOL_BIN) of its sum of |p|, K3 alone within
    TOL_SIGNED_FOLD of the fold of |p|. Returns the errors/bound."""
    nx, ny = int(p.shape[0]), int(p.shape[1])
    nbins = max(nx, ny, nz) // 2 - 1
    _, got = ck.shell_bin_sums_rfft_scalar(p, nbins, nz)
    p64 = p.double()
    out = {}
    if nx % 2 == 0 and ny % 2 == 0:
        fold64, abs64 = ck._fold_plain(p64), ck._fold_plain(p64.abs())
        folded, _ = ck.fold_quadrants_pair(p, p)
        out["fold"] = float(((folded.double() - fold64).abs()
                             / (TOL_SIGNED_FOLD * abs64).clamp(min=1e-300)).max())
        ref = ck._shell_bin_folded_plain(fold64, None, nbins, ny, nz)[0]
        ref_abs = ck._shell_bin_folded_plain(abs64, None, nbins, ny, nz)[0]
        bound = TOL_SIGNED_FOLD + TOL_BIN
        del fold64, abs64, folded
    else:
        ref = ck._shell_bin_unfolded_plain(p64, None, nbins, nz)[0]
        ref_abs = ck._shell_bin_unfolded_plain(p64.abs(), None, nbins, nz)[0]
        bound = TOL_BIN
    out["bins"] = float(((got - ref).abs() / (bound * ref_abs).clamp(min=1e-300)).max())
    out["negative_shells"] = int((ref < 0).sum())
    say(f"phase {phase} {what} on the signed helicity density {tuple(p.shape)}: error/bound {out}")
    if not max(out.get("fold", 0.0), out["bins"]) <= 1.0 or not out["negative_shells"]:
        fail(f"{what}: the signed binning disagrees with its plain version, or no shell is negative")
    return out


def gradient_scales(np, ref):
    """The natural scale of each entry of a gradient-statistics report:
    the p-th central moment of g_ij against c2_ij^(p/2), the mean against
    sqrt(c2_ij), the normalised ratios against 1, the squared-gradient
    sums against the pseudo-dissipation, the velocity mean against its
    standard deviation."""
    c2 = np.asarray(ref["gradient_moment2"])
    sums = ref["pseudo_dissipation"]
    return {
        "gradient_mean": np.sqrt(c2), "gradient_moment2": c2, "gradient_moment3": c2**1.5,
        "gradient_moment4": c2**2, "longitudinal_skewness": 1.0, "derivative_skewness": 1.0,
        "longitudinal_flatness": 1.0, "derivative_flatness": 1.0, "transverse_flatness": 1.0,
        "pseudo_dissipation": sums, "enstrophy": sums, "dilatation_msq": sums,
        "velocity_mean": np.sqrt(ref["velocity_variance"]), "velocity_variance": ref["velocity_variance"],
        "taylor_microscale": ref["taylor_microscale"], "taylor_microscale_mean": ref["taylor_microscale_mean"],
    }


SUMMARY_REAL_SPACE = ("u_rms", "kinetic_energy", "kinetic_energy_density", "mean_s", "sigma_s",
                      "mach_rms", "mach_max", "sound_speed_mean")


def compare_velocity(np, got, ref, what, phase, ncells, scales=None):
    """Hold the velocity diagnostics to the float64 path (error/bound per
    array): spectra and fields TOL_SPECTRA of scale (the helicity
    spectrum's from signed_scales, the fields' from ``scales``), with NaN
    in the same shells; transfer and flux
    TOL_TRANSFER of the sum of their shells' bounds (signed_scales;
    without it, of sum |T|); the summary's real-space
    entries TOL_SUMS (relative; float64 sums of the same values, ln rho
    in float64 on both sides), its spectral ones TOL_SPECTRA; gradient
    statistics TOL_GRADIENT of each entry's natural scale; the Q-R counts
    within MAX_QR_MOVED of the cells moved, Q_w TOL_SPECTRA, the edges
    exact. ``scales`` overrides a spectrum's scale (signed_scales)."""
    worst = {}
    scales = scales or {}
    for name, r in ref.items():
        g = got[name]
        if name == "transfer spectra":
            scale = scales.get(name, float(np.abs(r["transfer"]).sum()))
            for key in ("transfer", "flux"):
                worst[f"{name}/{key}"] = float(np.abs(g[key] - r[key]).max() / scale / TOL_TRANSFER)
        elif name.endswith("spectra"):
            for key, rv in r.items():
                gv = np.asarray(g[key])
                if key.startswith("k"):
                    worst[f"{name}/{key}"] = 0.0 if np.array_equal(gv, rv) else float("inf")
                    continue
                if not np.array_equal(np.isnan(gv), np.isnan(rv)):
                    fail(f"{what} {name}/{key}: NaN in other shells than the float64 path's")
                ok = ~np.isnan(rv)
                worst[f"{name}/{key}"] = float(np.abs(gv[ok] - rv[ok]).max()
                                               / scales.get(name, np.abs(rv[ok]).max()) / TOL_SPECTRA)
        elif name == "turbulence summary":
            if list(g) != list(r):
                fail(f"{what} summary entries {list(g)} vs {list(r)}")
            for key, rv in r.items():
                tol = TOL_SUMS if key in SUMMARY_REAL_SPACE else TOL_SPECTRA
                worst[f"{name}/{key}"] = abs(g[key] - rv) / max(abs(rv), 1e-300) / tol
        elif name == "velocity gradient statistics":
            for key, scale in gradient_scales(np, r).items():
                err = np.abs(np.asarray(g[key]) - np.asarray(r[key])) / np.maximum(scale, 1e-300)
                worst[f"{name}/{key}"] = float(np.max(err)) / TOL_GRADIENT
        elif name == "gradient invariant pdfs":
            for key in ("q_edges", "r_edges"):
                worst[f"{name}/{key}"] = 0.0 if np.array_equal(g[key], r[key]) else float("inf")
            worst[f"{name}/q_w"] = abs(g["q_w"] - r["q_w"]) / r["q_w"] / TOL_SPECTRA
            moved = float(np.abs(g["counts"] - r["counts"]).sum()) / 2
            worst[f"{name}/counts moved"] = moved / ncells / MAX_QR_MOVED
        else:  # fields: Helmholtz parts, vorticity, dilatation
            flat = {f"{k}/{c}": v for k, d in r.items() for c, v in (d.items() if isinstance(d, dict) else [("", d)])}
            gflat = {f"{k}/{c}": v for k, d in g.items() for c, v in (d.items() if isinstance(d, dict) else [("", d)])}
            for key, rv in flat.items():
                scale = scales.get(name, float(np.abs(rv).max()))
                worst[f"{name}/{key}"] = float(np.abs(gflat[key] - rv).max()) / max(scale, 1e-300) / TOL_SPECTRA
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what} vs the plain float64 path: {len(worst)} arrays, worst error/bound "
        f"{worst[top]!r} ({top})")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with the plain float64 path (error/bound): {bad}")
    return worst


def check_velocity_outputs(np, results, shape):
    """Every output finite (the spectra: in every shell, as the float64
    path on a cube) and of its shape."""
    nbins = max(shape) // 2 - 1
    for name, out in results.items():
        leaves = out.items() if isinstance(out, dict) else [("", out)]
        for key, v in leaves:
            for sub, a in (v.items() if isinstance(v, dict) else [("", v)]):
                a = np.asarray(a)
                if not np.isfinite(a).all():
                    fail(f"phase 22 {name} {key} {sub}: not finite")
    for name in ("enstrophy spectra", "helicity spectra"):
        if name in results and results[name]["power"].shape != (nbins,):
            fail(f"phase 22 {name}: {results[name]['power'].shape} shells, expected {nbins}")
    if ("helmholtz decomposition" in results
            and results["helmholtz decomposition"]["solenoidal"]["velx"].shape != shape):
        fail("phase 22 helmholtz decomposition: wrong field shape")


def helmholtz_identities(torch, vels, phase):
    """On the card: the Helmholtz parts sum to the input (float32: within
    4 * 2^-24 of |v| + |comp|); the solenoidal part's divergence and the
    compressive part's curl vanish to the derivative of float32 rounding:
    sol = v - comp carries ~2^-24 |v| of it at every wavenumber, which the
    spectral derivative raises by up to |k| (integer k here, sum n_i/2 at
    the Nyquist corner), so both are held within TOL_IDENTITY * max |v| *
    sum_i n_i/2. Also printed: both against the input's own largest
    divergence or curl."""
    from fava_tpu_torch.ops import velocity as vel_ops

    hd = vel_ops.helmholtz_decompose(*vels)
    names = ("velx", "vely", "velz")
    sol = [hd["solenoidal"][n] for n in names]
    comp = [hd["compressive"][n] for n in names]
    del hd
    out = {"sum": max(float(((s + c - v).abs() / (4 * 2.0**-24 * (v.abs() + c.abs())).clamp(min=1e-30)).max())
                      for s, c, v in zip(sol, comp, vels))}
    bound = TOL_IDENTITY * max(float(v.abs().max()) for v in vels) * sum(int(n) // 2 for n in vels[0].shape)
    deriv = max(float(vel_ops.dilatation(*vels).abs().max()),
                *(float(w.abs().max()) for w in vel_ops.vorticity(*vels)))
    div_sol = float(vel_ops.dilatation(*sol).abs().max())
    del sol
    curl_comp = max(float(w.abs().max()) for w in vel_ops.vorticity(*comp))
    out.update({"div_solenoidal": div_sol / bound, "curl_compressive": curl_comp / bound})
    say(f"phase {phase} Helmholtz identities on the card, error/bound: {out}; max |div sol| and "
        f"|curl comp| of the input's largest divergence or curl: {div_sol / deriv!r}, {curl_comp / deriv!r}")
    if not max(out.values()) <= 1.0:
        fail("the Helmholtz parts do not sum to the input or are not divergence/curl free")
    return out


def layer_breakdown(torch, ck, vel_ops, grad_ops, uni, wall_s):
    """Where the time of the window's analyses goes, by CUDA events (mean
    of 3 warm calls; Helmholtz 1): the three forward transforms, the
    enstrophy density (transforms included), K3 + B4 on it, the whole
    enstrophy spectrum with its fetch; the summary's and the gradient
    statistics' device vectors beside the calls that fetch them; the
    Helmholtz projection on the card beside its warm wall (``wall_s``),
    the rest of which is the copy of its six fields to the host."""
    vels = [uni.mesh.data(f"vel{a}") for a in "xyz"]
    dens = uni.mesh.data("dens")
    lengths = uni.mesh._domain_lengths()
    shape = tuple(int(s) for s in vels[0].shape)
    nbins = max(shape) // 2 - 1
    p = vel_ops.spectrum_density(vels, shape, lengths, "enstrophy").contiguous()
    out = {
        "rfftn_x3_ms": cuda_ms(torch, lambda: [vel_ops._rfft(v) for v in vels], 3),
        "enstrophy_density_ms": cuda_ms(
            torch, lambda: vel_ops.spectrum_density(vels, shape, lengths, "enstrophy"), 3),
        "k3_b4_ms": cuda_ms(torch, lambda: ck.shell_bin_sums_rfft_scalar(p, nbins, shape[2]), 3),
        "enstrophy_spectrum_ms": cuda_ms(
            torch, lambda: vel_ops.enstrophy_spectrum(*vels, lengths=lengths), 3),
        "summary_device_ms": cuda_ms(
            torch, lambda: vel_ops.turbulence_summary_device(*vels, dens=dens, lengths=lengths), 3),
        "summary_ms": cuda_ms(
            torch, lambda: vel_ops.turbulence_summary(*vels, dens=dens, lengths=lengths), 3),
        "gradient_device_ms": cuda_ms(
            torch, lambda: grad_ops.gradient_stats_device(vels, lengths=lengths), 3),
        "gradient_ms": cuda_ms(
            torch, lambda: grad_ops.velocity_gradient_statistics(*vels, lengths=lengths), 3),
        "helmholtz_device_ms": cuda_ms(
            torch, lambda: vel_ops.helmholtz_decompose(*vels, lengths=lengths), 1),
    }
    del p
    out["helmholtz_wall_ms"] = wall_s * 1e3
    say(f"phase 22 layer breakdown on the window (CUDA events, ms): {json.dumps(out)}")
    return out


def random_velocity_fields(torch, n, seed):
    """Seeded fields on the card: each velocity component an independent
    Gaussian field with |v̂(k)| ~ k^(-11/6) (E(k) ~ k^-5/3) and unit rms;
    lognormal density (sigma_s 0.3), polytropic pressure 0.6 rho^1.4 and
    gamc 1.4 + 0.05 tanh of a fourth field."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.fft.fftfreq(n, 1.0 / n, device="cuda")
    k = torch.sqrt(f[:, None, None] ** 2 + f[None, :, None] ** 2
                   + torch.fft.rfftfreq(n, 1.0 / n, device="cuda")[None, None, :] ** 2)
    amp = torch.where(k > 0, k.clamp(min=1.0) ** (-11.0 / 6.0), torch.zeros((), device="cuda"))
    del k, f

    def field():
        re = torch.randn(amp.shape, generator=gen, device="cuda")
        im = torch.randn(amp.shape, generator=gen, device="cuda")
        v = torch.fft.irfftn(torch.complex(re * amp, im * amp), s=(n, n, n))
        return v / v.square().mean().sqrt()

    out = {f"vel{a}": field() for a in "xyz"}
    out["dens"] = torch.exp(0.3 * field())
    out["pres"] = 0.6 * out["dens"] ** 1.4
    out["gamc"] = 1.4 + 0.05 * torch.tanh(field())
    return out


def phase_velocity_random(torch, np, workdir: Path):
    """Phase 22, second file: the analyses the window cannot exercise on a
    512^3 file of seeded compressible, helical random velocity (see
    RANDOM_SEED): the Helmholtz identities on the card; the helicity,
    transfer, decomposed (weighted) spectra and the summary with its Mach
    statistics, counted and held to the float64 path on the CPU (transfer
    and flux to sum |T|, the rest to their own scales); the Helmholtz
    parts, vorticity and dilatation on a CUT_FIELDS^3 cut, each to its
    own scale."""
    import fava_tpu_torch
    from fava_tpu_torch.io import synthetic
    from fava_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    rdir = workdir / "random"
    rdir.mkdir()
    names = list(NAMES) + ["pres", "gamc"]
    synthetic.make_uniform_file(rdir / "rt_hdf5_uniform_0001", ncells=(N, N, N),
                                field_data=random_velocity_fields(torch, N, RANDOM_SEED))
    torch.cuda.empty_cache()
    times = {"make_and_write_s": time.perf_counter() - t0}
    rnd = fava_tpu_torch.FLASH(rdir)
    rnd.load(file_type="uni", file_index=0, fields=names)
    vels = [rnd.mesh.data(f"vel{a}") for a in "xyz"]
    shape = tuple(int(s) for s in vels[0].shape)
    times["helmholtz_identities"] = helmholtz_identities(torch, vels, 22)
    del vels
    torch.cuda.empty_cache()
    runs = {k: v for k, v in velocity_runs(rnd).items() if k in RANDOM_RUNS}
    results, times["walls_s"], totals = run_exact_counts(torch, ck, 22, runs, "random")
    check_velocity_outputs(np, results, shape)

    t0 = time.perf_counter()
    cpu = fava_tpu_torch.FLASH(rdir, device="cpu")
    cpu.load(file_type="uni", file_index=0, fields=names)
    ref = {k: fn() for k, (fn, _) in velocity_runs(cpu).items() if k in RANDOM_RUNS}
    c = CUT_FIELDS
    cut_cpu = fava_tpu_torch.from_arrays(
        {f"vel{a}": cpu.mesh.data(f"vel{a}")[:c, :c, :c].numpy() for a in "xyz"}, device="cpu")
    cut_gpu = fava_tpu_torch.from_arrays(
        {f"vel{a}": rnd.mesh.data(f"vel{a}")[:c, :c, :c] for a in "xyz"})
    for name in ("helmholtz decomposition", "vorticity", "dilatation"):
        ref[name] = velocity_runs(cut_cpu)[name][0]()
        results[name] = velocity_runs(cut_gpu)[name][0]()
    del cpu, cut_cpu, cut_gpu
    rnd.mesh = None
    times["cpu_reference_s"] = time.perf_counter() - t0
    summary = ref["turbulence summary"]
    helicity = ref["helicity spectra"]["power"]
    times["input"] = {"compressive_fraction": summary["compressive_fraction"],
                      "mach_rms": summary["mach_rms"],
                      "helicity_shells_negative_positive": [int((helicity < 0).sum()),
                                                            int((helicity > 0).sum())],
                      "transfer_abs_sum": float(np.abs(ref["transfer spectra"]["transfer"]).sum())}
    say(f"phase 22 random file: {json.dumps(times['input'])}; float64 path on the CPU "
        f"{times['cpu_reference_s']:.1f} s")
    if not (summary["compressive_fraction"] >= MIN_COMPRESSIVE and min(times["input"][
            "helicity_shells_negative_positive"]) > 0 and times["input"]["transfer_abs_sum"] > 0):
        fail("the random file does not exercise the compressive part, helicity and transfer")
    errs = compare_velocity(np, results, ref, "random-file velocity diagnostics", 22, math.prod(shape))
    times["error_over_bound"] = {name: max(v for k, v in errs.items() if k.split("/")[0] == name)
                                 for name in dict.fromkeys(k.split("/")[0] for k in errs)}
    torch.cuda.empty_cache()
    times["streamed_vs_incore"] = streamed_vs_incore_random(torch, np, rdir)
    return totals, times


def series_against_files(np, series, singles, what, phase):
    """Each snapshot's row of a series equal to the analysis run on its
    file alone (the same function on the same values): TOL_RERUN of
    max(|ref|, 1) per entry."""
    worst = 0.0
    for j, single in enumerate(singles):
        for key, r in single.items():
            err = np.abs(np.asarray(series[key][j]) - np.asarray(r)).max() / max(np.abs(r).max(), 1.0)
            worst = max(worst, float(err) / TOL_RERUN)
    say(f"phase {phase} {what}: {len(singles)} rows against the analysis on each file, worst "
        f"error/bound {worst!r}")
    if not worst <= 1.0:
        fail(f"{what} disagrees with the analysis run on each file")
    return worst


def phase_velocity(torch, np, workdir: Path, card: str):
    """Phase 22: the 11 velocity-diagnostic and gradient analyses on the
    512^3 window (and the enstrophy spectrum on its 511-wide cut), the
    kernels on their signed and Q-R inputs, and summary_series and
    gradient_series over phase 17's files."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import gradients as grad_ops
    from fava_tpu_torch.ops import velocity as vel_ops

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    uni = fava_tpu_torch.FLASH(workdir)
    uni.load(file_type="uni", file_index=0, fields=list(NAMES))
    vels = [uni.mesh.data(f"vel{a}") for a in "xyz"]
    shape = tuple(int(s) for s in vels[0].shape)
    times = {"card": card}

    # The kernels on this phase's inputs: the signed helicity density through
    # K3 + B4 (and B10 on the 511-wide cut), B8 on the card's own Q and R.
    p = vel_ops.spectrum_density(vels, shape, None, "helicity").contiguous()
    times["signed_binning"] = check_signed_binning(torch, ck, p, shape[2], 22, "K3 + B4")
    cut = [v[: N - 1].contiguous() for v in vels]
    p = vel_ops.spectrum_density(cut, (N - 1,) + shape[1:], None, "helicity").contiguous()
    times["signed_binning_odd"] = check_signed_binning(torch, ck, p, shape[2], 22, "B10")
    del p
    spacings = grad_ops._spacings(shape, uni.mesh._domain_lengths())
    Q, R, qw = grad_ops.invariant_fields(vels, spacings, "periodic")
    qs = max(float(qw), grad_ops.QW_FLOOR)
    xe, ye = np.linspace(-8.0 * qs, 8.0 * qs, 101), np.linspace(-8.0 * qs**1.5, 8.0 * qs**1.5, 101)
    got = ck.pdf2d_counts(Q.reshape(-1), R.reshape(-1), xe, ye)
    ref = ck._pdf2d_plain(Q.reshape(-1).double(), R.reshape(-1).double(), xe, ye)
    if not torch.equal(got, ref):
        fail(f"B8 on the card's Q and R differs from its plain version in "
             f"{int((got != ref).sum())} bins")
    say(f"phase 22 B8 on the card's float32 Q and R ({Q.numel()} cells, Q_w {float(qw)!r}): counts "
        f"equal to the plain version's, {int(ref.sum())} inside")
    del Q, R, got, ref
    times["helmholtz_identities"] = helmholtz_identities(torch, vels, 22)
    scales = signed_scales(torch, ck, vel_ops, vels, uni.mesh._domain_lengths())
    del vels
    torch.cuda.empty_cache()

    results, walls, totals = run_exact_counts(torch, ck, 22, velocity_runs(uni), "window")
    check_velocity_outputs(np, results, shape)
    times["layers_ms"] = layer_breakdown(torch, ck, vel_ops, grad_ops, uni,
                                         walls["helmholtz decomposition"])
    torch.cuda.empty_cache()
    odd = fava_tpu_torch.from_arrays({f"vel{a}": v for a, v in zip("xyz", cut)})
    odd_ens, odd_counts = counted(torch, ck, "511x512x512 enstrophy spectra", odd.enstrophy_spectra,
                                  ("shell_bin_sums_unfolded",), 22)
    if odd_counts["shell_bin_sums_unfolded"] != 1 or odd_counts["fold_quadrants_pair"]:
        fail(f"the odd-extent enstrophy spectrum launched {odd_counts}")
    add_counts(totals, odd_counts)
    walls["enstrophy spectra 511"] = wall_per_call(torch, odd.enstrophy_spectra, 1)[0]
    del odd, cut
    times["walls_s"] = walls
    times["peak_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()

    # The float64 path on the CPU over the same float32 values; the fields
    # on a 128^3 cut of the window.
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = fava_tpu_torch.FLASH(workdir, device="cpu")
    cpu.load(file_type="uni", file_index=0, fields=list(NAMES))
    field_runs = ("helmholtz decomposition", "vorticity", "dilatation")
    ref = {name: fn() for name, (fn, _) in velocity_runs(cpu).items() if name not in field_runs}
    c = CUT_FIELDS
    cut_cpu = fava_tpu_torch.from_arrays(
        {f"vel{a}": cpu.mesh.data(f"vel{a}")[:c, :c, :c].numpy() for a in "xyz"}, device="cpu")
    cut_gpu = fava_tpu_torch.from_arrays(
        {f"vel{a}": uni.mesh.data(f"vel{a}")[:c, :c, :c] for a in "xyz"})
    for name in field_runs:
        ref[name] = velocity_runs(cut_cpu)[name][0]()
        results[name] = velocity_runs(cut_gpu)[name][0]()
    # A part or a derivative may vanish (a solenoidal window has no
    # compressive part): the parts are held to the largest |v| of the cut,
    # vorticity and dilatation to its largest first derivative.
    scales["helmholtz decomposition"] = max(float(cut_cpu.mesh.data(f"vel{a}").abs().max()) for a in "xyz")
    scales["vorticity"] = scales["dilatation"] = max(
        float(np.abs(ref["dilatation"]["dilatation"]).max()),
        *(float(np.abs(w).max()) for w in ref["vorticity"].values()))
    odd_cpu = fava_tpu_torch.from_arrays(
        {f"vel{a}": cpu.mesh.data(f"vel{a}")[: N - 1].numpy() for a in "xyz"}, device="cpu")
    ref_odd = {"enstrophy spectra": odd_cpu.enstrophy_spectra()}
    del cpu, cut_cpu, cut_gpu, odd_cpu
    times["cpu_reference_s"] = time.perf_counter() - t0
    say(f"phase 22 plain float64 path on the CPU: {times['cpu_reference_s']:.1f} s")
    times["scales"] = scales
    errs = compare_velocity(np, results, ref, "window velocity diagnostics", 22, math.prod(shape),
                            scales)
    odd_errs = compare_velocity(np, {"enstrophy spectra": odd_ens}, ref_odd, "511-wide enstrophy", 22,
                                (N - 1) * N * N)
    dec = results["decomposed spectra"]
    times["decomposed_identity"] = float(np.abs(dec["total"] - dec["solenoidal"] - dec["compressive"]).max()
                                         / np.abs(dec["total"]).max()) / TOL_SPECTRA
    say(f"phase 22 decomposed total = solenoidal + compressive on the card: error/bound "
        f"{times['decomposed_identity']!r}")
    if not times["decomposed_identity"] <= 1.0:
        fail("the decomposed spectra do not add up")
    times["error_over_bound"] = {name: max(v for k, v in errs.items() if k.split("/")[0] == name)
                                 for name in dict.fromkeys(k.split("/")[0] for k in errs)}
    times["error_over_bound"]["enstrophy spectra 511"] = max(odd_errs.values())
    del results, ref
    uni.mesh = None
    torch.cuda.empty_cache()
    random_totals, times["random"] = phase_velocity_random(torch, np, workdir)
    add_counts(totals, random_totals)

    # The two series over phase 17's four 512^3 files, each row held to the
    # analysis on its file alone.
    model = fava_tpu_torch.FLASH(workdir)
    nsnap = model.nfiles("uni")
    for what, series_fn, single_fn in (
            ("summary_series", model.summary_series, lambda: model.turbulence_summary()),
            ("gradient_series", model.gradient_series, lambda: model.velocity_gradient_statistics())):
        t0 = time.perf_counter()
        series, n = counted(torch, ck, what, lambda: series_fn(file_type="uni"), (), 22)
        times[f"{what}_per_snapshot_s"] = (time.perf_counter() - t0) / nsnap
        if any(n.values()):
            fail(f"{what} launched {n}; it runs no kernel")
        singles = []
        for j in range(nsnap):
            model.load(file_type="uni", file_index=j, fields=list(NAMES))
            singles.append(single_fn())
        model.mesh = None
        times[f"{what}_error_over_bound"] = series_against_files(np, series, singles, what, 22)
    del model
    torch.cuda.empty_cache()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 22 velocity diagnostics timings: {json.dumps(times)}")
    return totals, times


# ---------------------------------------------------------------------------
# Phase 23 (and the streamed checks of phases 14, 15 and 22): the filtered
# kinetic-energy flux, the two-point and velocity correlations and the four
# streamed statistics drivers


def first_crossing(np, line):
    """Index of the first sample <= 0 of a line normalised by its R(0) (the
    line's length when it stays positive): where _integral_scale stops."""
    neg = np.nonzero(np.asarray(line) <= 0)[0]
    return int(neg[0]) if neg.size else len(line)


def hold_lines(np, got, ref, tol, what, phase, keys=None):
    """Correlation lines against a reference (error/bound per array):
    lines normalised by R(0) (R_*, f_*, g_*, R_shell) within ``tol``; the
    separations exact; ``variance`` relative ``tol``; an integral scale
    (L11, L22, integral_scale) only where both runs cross zero at the same
    sample j, within tol * dx * (j + 3) (the trapezoid's j samples and the
    interpolated triangle, whose sensitivity to either end sample is below
    1.5 dx); where they do not, the sample that flipped must lie within
    ``tol`` of zero in both runs (a float32 sign flip at a near-zero
    sample). The isotropy ratio L11 / (2 L22) where both of its scales
    were held, within the sum of their relative bounds. Returns the worst
    error/bound and the crossings that differed."""
    worst, moved, bounds = {}, [], {}
    keys = [k for k in ref if keys is None or k in keys]
    for key in keys:
        r, g = ref[key], got[key]
        if key.startswith("r_"):
            worst[key] = 0.0 if np.array_equal(g, r) else float("inf")
        elif key == "variance":
            worst[key] = abs(g - r) / abs(r) / tol
        elif key.split("_")[0] in ("R", "f", "g"):
            if not np.array_equal(np.isnan(g), np.isnan(r)):
                fail(f"{what} {key}: NaN in other shells")
            ok = ~np.isnan(r)
            worst[key] = float(np.abs(np.asarray(g)[ok] - r[ok]).max()) / tol
        elif key.startswith(("L11_", "L22_", "integral_scale_")):
            ax = key[-1]
            line = {"L11": "f_", "L22": "g_", "integral": "R_"}[key.split("_")[0]] + ax
            lg, lr = np.asarray(got[line]), np.asarray(ref[line])
            jg, jr = first_crossing(np, lg), first_crossing(np, lr)
            if jg == jr:
                bounds[key] = tol * float(ref[f"r_{ax}"][1]) * (jr + 3)
                worst[key] = abs(got[key] - r) / bounds[key]
            else:
                j = min(jg, jr)
                near = abs(jg - jr) == 1 and max(abs(lg[j]), abs(lr[j])) <= tol
                moved.append({"scale": key, "crossings": [jg, jr], "near_zero": bool(near)})
                worst[key] = 0.0 if near else float("inf")
    for key in keys:
        ax = key[-1]
        if key.startswith("isotropy_ratio_") and {f"L11_{ax}", f"L22_{ax}"} <= set(bounds):
            rel = sum(bounds[k] / abs(ref[k]) for k in (f"L11_{ax}", f"L22_{ax}"))
            worst[key] = abs(got[key] - ref[key]) / (rel * abs(ref[key]))
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what}: {len(worst)} arrays, worst error/bound {worst[top]!r} ({top})"
        + (f"; crossings that differ: {moved}" if moved else ""))
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with its reference (error/bound): {bad}")
    return {"worst": worst[top], "crossings_differ": moved}


def flux_transforms(torch, vels, dens, pres):
    """The unnormalized real transforms the flux filters (its definitions,
    ops/coarse_grain.py): rho, rho u_i, rho u_i u_j for i <= j (u_i and
    u_i u_j with ``dens`` None), and p and u_j with ``pres``."""
    nd = len(vels)

    def rf(x):
        return torch.fft.rfftn(x if dens is None else dens * x)

    f = {"rho": None if dens is None else torch.fft.rfftn(dens), "mom": [rf(v) for v in vels],
         "qq": {(i, j): rf(vels[i] * vels[j]) for i in range(nd) for j in range(i, nd)}}
    if pres is not None:
        f["p"] = torch.fft.rfftn(pres)
        f["u"] = [torch.fft.rfftn(v) for v in vels]
    return f


def flux_term_scales(torch, cg, vel_ops, vels, dens, pres, kcs, kernel, lengths):
    """The magnitude scale of each cutoff's flux statistics, from the same
    filtered terms the flux is made of: S_pi = mean over cells of
    sum_ij (|bar(rho u_i u_j)| + |rho_b u~_i u~_j|) |d_j u~_i| (tau is their
    difference, which cancels towards small scales), and with ``pres``
    S_lambda = mean of sum_j |d_j bar(p)| (|bar(rho u_j)| + |rho_b bar(u_j)|)
    / rho_b. ``dens=None``: rho = 1. Float64 means of the given dtype's
    terms (the scale needs no more)."""
    shape = tuple(int(s) for s in vels[0].shape)
    nd = len(shape)
    f = flux_transforms(torch, vels, dens, pres)
    spec0 = f["mom"][0]
    rdt, dev = spec0.real.dtype, spec0.device
    k2 = cg._k2_int(shape, rdt, dev)
    dks = vel_ops._k_grids(shape, rdt, dev, lengths, True)
    out = []
    for kc in kcs:
        g = cg._filter_gain(k2, float(kc), kernel)

        def bar(s):
            return torch.fft.irfftn(g * s, s=shape)

        mb = [bar(s) for s in f["mom"]]
        rb = bar(f["rho"]) if dens is not None else None
        ub = [m / rb for m in mb] if dens is not None else mb
        drb = [bar(1j * dks[j] * f["rho"]) for j in range(nd)] if dens is not None else None
        s_pi = 0.0
        for i in range(nd):
            for j in range(nd):
                d = bar(1j * dks[j] * f["mom"][i])
                du = (d - ub[i] * drb[j]) / rb if dens is not None else d
                q = bar(f["qq"][(min(i, j), max(i, j))])
                r = ub[i] * ub[j] if dens is None else rb * ub[i] * ub[j]
                s_pi += float(((q.abs() + r.abs()) * du.abs()).to(torch.float64).mean())
        row = {"pi": s_pi}
        if pres is not None:
            s_l = 0.0
            for j in range(nd):
                dp = bar(1j * dks[j] * f["p"])
                s_l += float((dp.abs() * (mb[j].abs() + (rb * bar(f["u"][j])).abs())
                              / rb.abs()).to(torch.float64).mean())
            row["baropycnal"] = s_l
        out.append(row)
    return out


def hold_flux(np, got, ref, scales, tol, what, phase):
    """Flux statistics against a reference, each cutoff's mean and rms
    within ``tol`` of its term scale (flux_term_scales)."""
    if sorted(got) != sorted(ref) or not np.array_equal(got["kc"], ref["kc"]):
        fail(f"{what}: keys or cutoffs differ")
    worst = {}
    for key in ref:
        if key in ("kc", "scale"):
            continue
        s = np.array([row[key.rsplit("_", 1)[0]] for row in scales])
        worst[key] = float((np.abs(np.asarray(got[key]) - ref[key]) / (tol * s)).max())
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what}: worst error/bound {worst[top]!r} ({top}); term scales "
        f"{[{k: float(v) for k, v in row.items()} for row in scales]}")
    if not worst[top] <= 1.0:
        fail(f"{what} disagrees with its reference (error/bound): {worst}")
    return worst[top]


def all_finite(np, out, what):
    for key, v in out.items():
        if key == "R_shell":  # empty shells are NaN by design
            continue
        if not np.isfinite(np.asarray(v, dtype=np.float64)).all():
            fail(f"{what} {key}: not finite")


def check_corr_binning(torch, ck, field, phase, what):
    """The shell binning of a signed correlation half-volume (two_point's
    K3 + B4 for even x and y, else B10) against its plain versions on the
    same float32 values in float64 (on the card), as check_signed_binning:
    within TOL_SIGNED_FOLD + TOL_BIN (B10: TOL_BIN) of each shell's sum of
    |corr|."""
    from fava_tpu_torch.ops.velocity import _irfft, _rfft

    shape = tuple(int(s) for s in field.shape)
    nbins = min(shape) // 2
    fm = field - field.double().mean().float()
    fh = _rfft(fm)
    corr = _irfft(fh.real.square() + fh.imag.square(), shape) / math.prod(shape)
    p = corr[..., : shape[2] // 2 + 1].contiguous()
    del fm, fh, corr
    _, got = ck.shell_bin_sums_rfft_scalar(p, nbins, shape[2])
    p64 = p.double()
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        ref = ck._shell_bin_folded_plain(ck._fold_plain(p64), None, nbins, shape[1], shape[2])[0]
        ref_abs = ck._shell_bin_folded_plain(ck._fold_plain(p64.abs()), None, nbins, shape[1],
                                             shape[2])[0]
        bound = TOL_SIGNED_FOLD + TOL_BIN
    else:
        ref = ck._shell_bin_unfolded_plain(p64, None, nbins, shape[2])[0]
        ref_abs = ck._shell_bin_unfolded_plain(p64.abs(), None, nbins, shape[2])[0]
        bound = TOL_BIN
    out = {"bins": float(((got - ref).abs() / (bound * ref_abs).clamp(min=1e-300)).max()),
           "negative_shells": int((ref < 0).sum())}
    say(f"phase {phase} {what} on the correlation half-volume {tuple(p.shape)}: error/bound {out}")
    if not out["bins"] <= 1.0:
        fail(f"{what}: the correlation binning disagrees with its plain version")
    return out


def flux_pieces_ms(torch, cg, vels, dens, kcs, kernel, lengths, reps=3):
    """Where the time of filtered_ke_flux goes, by CUDA events (mean of
    ``reps`` warm calls): the forward transforms; the sweep over the
    cutoffs, split into its inverse transforms (one timed, times the 22 a
    cutoff takes with dens and no pres) and the eager products (the rest:
    gains, products, quotients and the float64 sums); the fetch of the
    stacked sums; and the whole call. The body of one device
    (``SpaceRanks()``)."""
    from fava_tpu_torch.parallel import SpaceRanks

    shape = tuple(int(s) for s in vels[0].shape)
    ranks = SpaceRanks()
    f = cg._forward([vels], [dens], None, ranks)
    spec = f["mom"][0][0]
    g = cg._filter_gain(cg._k2_int(shape, spec.real.dtype, spec.device), float(kcs[0]), kernel)
    rows = [cg._scale_sums(f, shape, float(k), kernel, lengths, ranks)[0] for k in kcs]
    out = {
        "forward_ms": cuda_ms(torch, lambda: cg._forward([vels], [dens], None, ranks), reps),
        "one_inverse_ms": cuda_ms(torch, lambda: ranks.pencil_irfft([g * spec], shape), reps),
        "sweep_ms": cuda_ms(torch, lambda: [cg._scale_sums(f, shape, float(k), kernel, lengths,
                                                           ranks) for k in kcs], reps),
        "fetch_ms": cuda_ms(torch, lambda: torch.stack(rows, dim=1).cpu(), reps),
        "call_ms": cuda_ms(torch, lambda: cg.filtered_ke_flux(*vels, dens=dens, cutoffs=kcs,
                                                              kernel=kernel, lengths=lengths), reps),
    }
    del f, spec, g, rows
    out["inverse_transforms"] = 22 * len(kcs)
    out["inverse_ms"] = out["one_inverse_ms"] * out["inverse_transforms"]
    out["products_ms"] = out["sweep_ms"] - out["inverse_ms"]
    return out


def a8c_runs(model, with_corr=True):
    """The A8c analyses on a uniform model: {name: (fn, {kernel: launches})}
    on an even-extent window."""
    fold = {"fold_quadrants_pair": 1, "shell_bin_values_folded_1ch": 1}
    runs = {"filtered ke flux": (model.filtered_kinetic_energy_flux, {}),
            "velocity correlations": (model.velocity_correlations, {})}
    if with_corr:
        runs["two point correlation"] = (lambda: model.two_point_correlation("dens"), fold)
    return runs


def random_a8c_runs(model):
    return {"velocity correlations": (model.velocity_correlations, {}),
            "filtered ke flux pressure gaussian": (
                lambda: model.filtered_kinetic_energy_flux(with_pressure=True), {}),
            "filtered ke flux pressure sharp": (
                lambda: model.filtered_kinetic_energy_flux(with_pressure=True, kernel="sharp"), {})}


def hold_a8c(torch, np, cg, vel_ops, got, ref, cpu_mesh, what, phase, with_pres=False):
    """The card's A8c results on a cut against the float64 path on the CPU
    (same float32 values): the lines TOL_SPECTRA (hold_lines); the flux to
    TOL_FLUX of its term scales (the sharp kernel's Favre flux is printed
    only: it is held to identity (b))."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        if name.startswith("filtered ke flux"):
            kernel = "sharp" if name.endswith("sharp") else "gaussian"
            vels = [cpu_mesh.data(f"vel{a}") for a in "xyz"]
            pres = cpu_mesh.data("pres") if with_pres else None
            scales = flux_term_scales(torch, cg, vel_ops, vels, cpu_mesh.data("dens"), pres, r["kc"],
                                      kernel, cpu_mesh._domain_lengths())
            if kernel == "sharp":
                err = {k: float((np.abs(np.asarray(g[k]) - r[k])
                                 / np.array([s[k.rsplit("_", 1)[0]] for s in scales])).max())
                       for k in r if k not in ("kc", "scale")}
                say(f"phase {phase} {what} {name} (not held; sharp Favre, see identity (b)): "
                    f"max |diff| / term scale {err}")
                out[name] = err
            else:
                out[name] = hold_flux(np, g, r, scales, TOL_FLUX, f"{what} {name}", phase)
        else:
            out[name] = hold_lines(np, g, r, TOL_SPECTRA, f"{what} {name}", phase)
    return out


def identity_b(torch, np, rdir: Path, times):
    """Identity (b) at 512^3 on the card, both sides in the port: the
    solenoidal part of the random velocity file, the sharp filter at
    k_c = s + 0.5 (3 k_c < n keeps the products of the filtered field
    alias-free): <Pi_l> = flux(k_c) of transfer_spectrum, within
    TOL_TRANSFER of the sum of the two sides' magnitude scales (the term
    scale S_pi of the flux, sum_{k <= k_c} |T(k)| of the transfer)."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import coarse_grain as cg
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import velocity as vel_ops

    rnd = fava_tpu_torch.FLASH(rdir)
    rnd.load(file_type="uni", file_index=0, fields=["velx", "vely", "velz"])
    sol = vel_ops.helmholtz_decompose(*[rnd.mesh.data(f"vel{a}") for a in "xyz"])["solenoidal"]
    rnd.mesh = None
    sol = [sol[f"vel{a}"] for a in "xyz"]
    torch.cuda.empty_cache()
    shells = IDENTITY_SHELLS
    kcs = tuple(s + 0.5 for s in shells)
    ck.reset_launch_counts()
    flux = cg.filtered_ke_flux(*sol, cutoffs=kcs, kernel="sharp")
    tr = vel_ops.transfer_spectrum(*sol)
    torch.cuda.synchronize()
    scales = flux_term_scales(torch, cg, vel_ops, sol, None, None, kcs, "sharp", None)
    del sol
    torch.cuda.empty_cache()
    rows = []
    for i, s in enumerate(shells):
        t_abs = float(np.abs(tr["transfer"][: s + 1]).sum())
        bound = TOL_TRANSFER * (scales[i]["pi"] + t_abs)
        rows.append({"kc": kcs[i], "pi_mean": float(flux["pi_mean"][i]),
                     "spectral_flux": float(tr["flux"][s]), "term_scale": scales[i]["pi"],
                     "sum_abs_T": t_abs,
                     "error_over_bound": abs(flux["pi_mean"][i] - tr["flux"][s]) / bound})
    times["identity_b"] = rows
    say(f"phase 23 identity (b) at 512^3 on the card (solenoidal random velocity, sharp filter): "
        f"{json.dumps(rows)}")
    if not all(r["error_over_bound"] <= 1.0 for r in rows):
        fail("identity (b): <Pi_l> differs from the spectral flux at k_c")
    if not max(abs(r["spectral_flux"]) / (TOL_TRANSFER * (r["term_scale"] + r["sum_abs_T"]))
               for r in rows) >= 10:
        fail("identity (b): every spectral flux is too small for the check to mean anything")


def phase_a8c(torch, np, workdir: Path, card: str):
    """Phase 23: the filtered flux and the two-point and velocity
    correlations at 512^3 on the window (the pipeline's defaults), its
    511-wide cut and the random-velocity file, counted, finite and timed
    warm; the correlation volumes' binning against the plain versions;
    each held to the float64 CPU path on a CUT_FIELDS^3 cut; identity (b);
    the flux's pieces by CUDA events."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import coarse_grain as cg
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import velocity as vel_ops

    t_phase = time.perf_counter()
    times = {"card": card}
    torch.cuda.reset_peak_memory_stats()
    uni = fava_tpu_torch.FLASH(workdir)
    uni.load(file_type="uni", file_index=0, fields=list(NAMES))
    dens = uni.mesh.data("dens")
    times["binning"] = check_corr_binning(torch, ck, dens, 23, "K3 + B4")
    cut = dens[: N - 1].contiguous()
    times["binning_odd"] = check_corr_binning(torch, ck, cut, 23, "B10")
    results, times["walls_s"], totals = run_exact_counts(torch, ck, 23, a8c_runs(uni), "window")
    odd = fava_tpu_torch.from_arrays({"dens": cut})
    odd_tp, odd_counts = counted(torch, ck, "511x512x512 two point correlation",
                                 lambda: odd.two_point_correlation("dens"),
                                 ("shell_bin_sums_unfolded",), 23)
    if odd_counts["shell_bin_sums_unfolded"] != 1 or odd_counts["fold_quadrants_pair"]:
        fail(f"the odd-extent two-point correlation launched {odd_counts}")
    add_counts(totals, odd_counts)
    times["walls_s"]["two point correlation 511"] = wall_per_call(
        torch, lambda: odd.two_point_correlation("dens"), 1)[0]
    del odd, cut
    for name, out in list(results.items()) + [("two point correlation 511", odd_tp)]:
        all_finite(np, out, f"phase 23 window {name}")
    if odd_tp["R_shell"].shape != ((N - 1) // 2,) or results["two point correlation"][
            "R_shell"].shape != (N // 2,):
        fail("phase 23: wrong shell count of the two-point correlation")
    vels = [uni.mesh.data(f"vel{a}") for a in "xyz"]
    times["flux_pieces_ms"] = flux_pieces_ms(torch, cg, vels, dens, (4.0, 8.0, 16.0), "gaussian",
                                             uni.mesh._domain_lengths())
    say(f"phase 23 filtered_ke_flux pieces on the window (CUDA events, ms): "
        f"{json.dumps(times['flux_pieces_ms'])}")
    del vels, dens
    times["window_peak_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30

    # The float64 path on the CPU on a CUT_FIELDS^3 cut of the same values.
    torch.set_num_threads(os.cpu_count() or 1)
    c = CUT_FIELDS
    t0 = time.perf_counter()
    cpu = fava_tpu_torch.FLASH(workdir, device="cpu")
    cpu.load(file_type="uni", file_index=0, fields=list(NAMES))
    arrays = {k: cpu.mesh.data(k)[:c, :c, :c].numpy() for k in NAMES}
    del cpu
    cut_cpu = fava_tpu_torch.from_arrays(arrays, device="cpu")
    cut_gpu = fava_tpu_torch.from_arrays(arrays)
    ref = {k: fn() for k, (fn, _) in a8c_runs(cut_cpu).items()}
    got = {k: fn() for k, (fn, _) in a8c_runs(cut_gpu).items()}
    times["errors"] = hold_a8c(torch, np, cg, vel_ops, got, ref, cut_cpu.mesh, "window cut", 23)
    times["cpu_reference_s"] = time.perf_counter() - t0
    del cut_cpu, cut_gpu, got, ref
    uni.mesh = None
    torch.cuda.empty_cache()

    # The random-velocity file of phase 22 (compressible, with pres).
    rdir = workdir / "random"
    rnd = fava_tpu_torch.FLASH(rdir)
    rnd.load(file_type="uni", file_index=0, fields=list(NAMES) + ["pres"])
    rres, times["random_walls_s"], rtot = run_exact_counts(torch, ck, 23, random_a8c_runs(rnd),
                                                           "random")
    add_counts(totals, rtot)
    for name, out in rres.items():
        all_finite(np, out, f"phase 23 random {name}")
    arrays = {k: rnd.mesh.data(k)[:c, :c, :c].cpu().numpy() for k in list(NAMES) + ["pres"]}
    rnd.mesh = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cut_cpu = fava_tpu_torch.from_arrays(arrays, device="cpu")
    cut_gpu = fava_tpu_torch.from_arrays(arrays)
    ref = {k: fn() for k, (fn, _) in random_a8c_runs(cut_cpu).items()}
    got = {k: fn() for k, (fn, _) in random_a8c_runs(cut_gpu).items()}
    times["random_errors"] = hold_a8c(torch, np, cg, vel_ops, got, ref, cut_cpu.mesh, "random cut",
                                      23, with_pres=True)
    times["random_cpu_reference_s"] = time.perf_counter() - t0
    del cut_cpu, cut_gpu
    torch.cuda.empty_cache()
    identity_b(torch, np, rdir, times)
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 23 filtering and two-point timings: {json.dumps(times)}")
    return totals, times


def streamed_stat_runs(loader, shape, lines_field="dens", with_mach=False, **kw):
    """The four streamed drivers on a host slab loader: {name: fn}."""
    from fava_tpu_torch.ops import outofcore

    common = dict(slab_rows=SLAB_ROWS, **kw)
    return {
        "turbulence summary": lambda: outofcore.streamed_turbulence_summary(
            loader, shape, chunk_rows=CHUNK_ROWS, with_mach=with_mach, **common),
        "velocity gradient statistics": lambda: outofcore.streamed_gradient_stats(
            loader, shape, **common),
        "velocity correlations": lambda: outofcore.streamed_velocity_correlations(
            loader, shape, chunk_rows=CHUNK_ROWS, **common),
        "two point lines": lambda: outofcore.streamed_two_point_lines(
            loader, shape, lines_field, chunk_rows=CHUNK_ROWS, **common),
    }


def run_streamed_stats(torch, np, ck, runs, phase, what):
    """Each streamed driver once, counters reset before and read after (they
    launch no kernel), its wall and peak card memory."""
    results, times = {}, {}
    for name, fn in runs.items():
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        if launches:
            fail(f"streamed {name} launched {launches}; it runs no kernel")
        times[name] = {"wall_s": wall, "peak_allocated_GiB": torch.cuda.max_memory_allocated() / 2**30}
        all_finite(np, results[name], f"phase {phase} {what} streamed {name}")
    say(f"phase {phase} {what} streamed statistics (wall, peak card memory): {json.dumps(times)}")
    return results, times


def hold_summary(np, got, ref, what, phase, real_only=False):
    """A summary against a reference: real-space entries TOL_SUMS relative
    (float64 sums of the same float32 values), spectral ones TOL_SPECTRA
    (float32 transforms split otherwise)."""
    if not real_only and list(got) != list(ref):
        fail(f"{what}: entries {list(got)} vs {list(ref)}")
    worst = {}
    for key, r in ref.items():
        tol = TOL_SUMS if key in SUMMARY_REAL_SPACE else TOL_SPECTRA
        worst[key] = abs(got[key] - r) / max(abs(r), 1e-300) / tol
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what}: worst error/bound {worst[top]!r} ({top})")
    if not worst[top] <= 1.0:
        fail(f"{what} disagrees (error/bound): {worst}")
    return worst[top]


def hold_gradients(np, got, ref, what, phase):
    """Gradient statistics against a reference: the same float32
    differences summed in float64 in another order (and combined across
    slabs by Chan/Pebay): each entry within TOL_SUMS of its natural scale
    (gradient_scales)."""
    worst = {}
    for key, scale in gradient_scales(np, ref).items():
        err = np.abs(np.asarray(got[key]) - np.asarray(ref[key])) / np.maximum(scale, 1e-300)
        worst[key] = float(np.max(err)) / TOL_SUMS
    top = max(worst, key=worst.get)
    say(f"phase {phase} {what}: worst error/bound {worst[top]!r} ({top})")
    if not worst[top] <= 1.0:
        fail(f"{what} disagrees (error/bound): {worst}")
    return worst[top]


def streamed_vs_incore_random(torch, np, rdir: Path):
    """Phase 22: the random file through the mesh with ``streamed=True``
    (its _streamed_loader with check_fields, gamc on file) against the
    in-core analyses on the card: the summary with Mach statistics, the
    gradient statistics, the velocity correlations and the two-point
    lines of dens."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck

    rnd = fava_tpu_torch.FLASH(rdir)
    rnd.load(file_type="uni", file_index=0, fields=list(NAMES) + ["pres", "gamc"])
    runs = {"turbulence summary": rnd.turbulence_summary,
            "velocity gradient statistics": rnd.velocity_gradient_statistics,
            "velocity correlations": rnd.velocity_correlations,
            "two point lines": lambda: rnd.two_point_correlation("dens")}
    incore = {name: fn() for name, fn in runs.items()}
    knobs = {"slab_rows": SLAB_ROWS, "chunk_rows": CHUNK_ROWS}
    streamed_runs = {
        "turbulence summary": lambda: rnd.turbulence_summary(streamed=True, **knobs),
        "velocity gradient statistics": lambda: rnd.velocity_gradient_statistics(
            streamed=True, slab_rows=SLAB_ROWS),
        "velocity correlations": lambda: rnd.velocity_correlations(streamed=True, **knobs),
        "two point lines": lambda: rnd.two_point_correlation("dens", streamed=True, **knobs),
    }
    got, times = run_streamed_stats(torch, np, ck, streamed_runs, 22, "random 512^3 file")
    rnd.mesh = None
    torch.cuda.empty_cache()
    if "mach_rms" not in got["turbulence summary"]:
        fail("the streamed summary of the random file has no Mach statistics")
    times["errors"] = {
        "turbulence summary": hold_summary(np, got["turbulence summary"], incore["turbulence summary"],
                                           "streamed vs in-core summary", 22),
        "velocity gradient statistics": hold_gradients(
            np, got["velocity gradient statistics"], incore["velocity gradient statistics"],
            "streamed vs in-core gradient statistics", 22),
        "velocity correlations": hold_lines(np, got["velocity correlations"],
                                            incore["velocity correlations"], TOL_SPECTRA,
                                            "streamed vs in-core velocity correlations", 22),
        "two point lines": hold_lines(np, got["two point lines"], incore["two point lines"],
                                      TOL_SPECTRA, "streamed vs in-core two-point lines", 22,
                                      keys=set(got["two point lines"])),
    }
    return times


def streamed_lines_vs_incore(torch, np, hosts, incore, n, phase):
    """Phase 14: the streamed velocity correlations and two-point lines of
    dens from the 1024^3 host copy against the in-core analyses on the
    card (``incore``)."""
    from fava_tpu_torch.ops import cuda_kernels as ck

    runs = streamed_stat_runs(host_loader(hosts), (n, n, n))
    runs = {k: runs[k] for k in ("velocity correlations", "two point lines")}
    got, times = run_streamed_stats(torch, np, ck, runs, phase, f"{n}^3")
    times["errors"] = {
        name: hold_lines(np, got[name], incore[name], TOL_SPECTRA,
                         f"streamed vs in-core {name} at {n}^3", phase, keys=set(got[name]))
        for name in runs}
    return times


def streamed_beyond_incore(torch, np, hosts, n, phase):
    """Phase 15: the four streamed drivers on the 1280^3 host arrays (dens
    and velocities, so the summary has no Mach statistics), held to what
    plain float64 sums of the host arrays give (taken slab by slab on the
    card, where they cost seconds; on the host's cores they took 40 s):
    the summary's real-space entries (TOL_SUMS), the variance of dens from
    its two-point lines (TOL_SPECTRA: float32 transforms), the zero mean
    of every du_i/dx_j on the periodic box (within 2^-22 of its rms: the
    float32 differences telescope up to their rounding), and f(0) = g(0)
    = 1."""
    from fava_tpu_torch.ops import cuda_kernels as ck

    got, times = run_streamed_stats(torch, np, ck, streamed_stat_runs(host_loader(hosts), (n, n, n)),
                                    phase, f"{n}^3")
    t0 = time.perf_counter()
    acc = torch.zeros(6, dtype=torch.float64, device="cuda")
    for x0 in range(0, n, SLAB_ROWS):
        d, vx, vy, vz = (torch.from_numpy(hosts[k][x0 : x0 + SLAB_ROWS]).cuda().double()
                         for k in NAMES)
        u2 = vx.square() + vy.square() + vz.square()
        ld = d.log()
        acc += torch.stack([u2.sum(), (d * u2).sum(), d.sum(), ld.sum(), ld.square().sum(),
                            d.square().sum()])
        del d, vx, vy, vz, u2, ld
    ntot = float(n) ** 3
    s_u2, s_du2, s_d, s_ld, s_ld2, s_d2 = acc.tolist()
    mu_ld = s_ld / ntot
    host = {"u_rms": math.sqrt(s_u2 / ntot), "kinetic_energy": 0.5 * s_u2 / ntot,
            "kinetic_energy_density": 0.5 * s_du2 / ntot, "mean_s": mu_ld - math.log(s_d / ntot),
            "sigma_s": math.sqrt(max(s_ld2 / ntot - mu_ld**2, 0.0))}
    var = s_d2 / ntot - (s_d / ntot) ** 2
    times["float64_sums_s"] = time.perf_counter() - t0
    errs = {"summary": hold_summary(np, got["turbulence summary"], host,
                                    f"streamed {n}^3 summary vs plain float64 sums", phase,
                                    real_only=True)}
    errs["dens_variance"] = abs(got["two point lines"]["variance"] - var) / var / TOL_SPECTRA
    grad = got["velocity gradient statistics"]
    errs["gradient_mean"] = float((np.abs(grad["gradient_mean"])
                                   / (2.0**-22 * np.sqrt(grad["gradient_moment2"]))).max())
    vc = got["velocity correlations"]
    ones = all(vc[f"{k}_{ax}"][0] == 1.0 for k in ("f", "g") for ax in "xyz")
    say(f"phase {phase} streamed {n}^3 vs plain float64 sums (error/bound): {errs}; f(0) = g(0) = 1: "
        f"{ones}; the sums {times['float64_sums_s']:.1f} s")
    if not (max(errs.values()) <= 1.0 and ones):
        fail(f"the streamed statistics at {n}^3 disagree with the plain float64 sums: {errs}")
    times["errors"] = errs
    return times


# ---------------------------------------------------------------------------
# Phase 18: the fused-spectrum path (B9, B11, B12)


def fused_kernel_rows(torch, ck, fields, nbins):
    """Phase 18's kernel checks: B9, B11a, B11b and B12 against their plain
    versions at the path's shapes."""
    from fava_tpu_torch.experiments import folded_bins, planar_dft

    dens, *vels = fields
    nx, ny, nz = (int(s) for s in dens.shape)
    nzr = nz // 2 + 1
    static = ck._static_counts((nx, ny, nzr), nbins, nz, dens.device)
    rows = {}

    def rel(got, ref):
        err = (got - ref).abs()
        return float(err.max()), float((err / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())

    # B9 on the normalized stacked transforms, cuFFT's interleaved output read in place.
    re, im = planar_dft.velocity_transforms(dens, vels)
    counts, sums = ck.shell_bin_powers_fused(re, im, nbins, nz)
    torch.cuda.synchronize()
    ref = ck._powers_fused_plain(re.double(), im.double(), nbins, nz)
    if not (torch.equal(counts, ref[0]) and torch.equal(counts, static)):
        fail("shell_bin_powers_fused counts differ from the static counts")
    inside = inside_cells(ck, re[0], nbins, full_nz=nz)
    rows["shell_bin_powers_fused"] = kernel_row(
        torch, 18, "shell_bin_powers_fused", *rel(sums[:2], ref[1:]), TOL_BIN,
        lambda: ck.shell_bin_powers_fused(re, im, nbins, nz),
        lambda: ck._powers_fused_plain(re, im, nbins, nz), (24 * inside + 24 * nbins, 60 * inside))
    out9 = torch.zeros((3, nbins), dtype=torch.float64, device=dens.device)
    walk_report(torch, ck, 18, "shell_bin_powers_fused", rows["shell_bin_powers_fused"],
                ck.walk_launch("fava_shell_bin_powers_fused_blocks_per_sm", (1,), 3,
                               (nx // 2 + 1) * (ny // 2 + 1), nbins),
                "fava_shell_bin_powers_fused", re.data_ptr(), None, out9.data_ptr(), nx, ny, nzr, nbins,
                nz, 1)
    del re, im, ref, out9
    torch.cuda.empty_cache()

    # B11a and B11b on pad8 folds of the path's powers, NaN in the pad rows.
    total, longi = path_powers(torch, fields)
    folds = ck.fold_quadrants_pair(total, longi)
    del total, longi
    padded = [folded_bins.pad_rows8(f, float("nan")) for f in folds]
    ref = ck._onepass_plain(*(p.double() for p in padded), nbins, nx, ny, nz)
    inside = inside_cells(ck, padded[0], nbins, full_ny=ny)
    counts, sums = ck.shell_bin_sums_folded_onepass(*padded, nbins, nx, ny, nz)
    torch.cuda.synchronize()
    if not (torch.equal(counts, ref[0]) and torch.equal(counts, static)):
        fail("shell_bin_sums_folded_onepass counts differ from the static counts")
    say(f"phase 18 pad8 folds {tuple(padded[0].shape)} (rows {ny // 2 + 1}.. NaN): one-pass counts "
        "equal to the static counts")
    rows["shell_bin_sums_folded_onepass"] = kernel_row(
        torch, 18, "shell_bin_sums_folded_onepass", *rel(sums[:2], ref[1:]), TOL_BIN,
        lambda: ck.shell_bin_sums_folded_onepass(*padded, nbins, nx, ny, nz),
        lambda: ck._onepass_plain(*padded, nbins, nx, ny, nz), (8 * inside + 24 * nbins, 8 * inside))
    nxh, rows8, _ = padded[0].shape
    out3 = torch.zeros((3, nbins), dtype=torch.float64, device=dens.device)
    walk_report(torch, ck, 18, "shell_bin_sums_folded_onepass", rows["shell_bin_sums_folded_onepass"],
                ck.walk_launch("fava_shell_bin_folded_blocks_per_sm", (2, 1), 3, nxh * rows8, nbins),
                "fava_shell_bin_sums_folded_onepass", padded[0].data_ptr(), padded[1].data_ptr(),
                out3.data_ptr(), nxh, rows8, nzr, nbins, nx, ny, nz)
    got = torch.stack(ck.shell_bin_values_folded_rows(*padded, nbins, nx, ny, nz))
    k4 = ck.shell_bin_values_folded(*folds, nbins, ny, nz)
    torch.cuda.synchronize()
    k4_abs, k4_ratio = rel(got, k4)
    say(f"phase 18 shell_bin_values_folded_rows vs K4 on the unpadded folds: max |diff| {k4_abs!r}, "
        f"error/bound {k4_ratio!r} (bound {TOL_BIN!r})")
    if not k4_ratio <= 1.0:
        fail("shell_bin_values_folded_rows differs from K4's result")
    rows["shell_bin_values_folded_rows"] = kernel_row(
        torch, 18, "shell_bin_values_folded_rows", *rel(got, ref[1:]), TOL_BIN,
        lambda: ck.shell_bin_values_folded_rows(*padded, nbins, nx, ny, nz),
        lambda: ck._shell_bin_folded_plain(*padded, nbins, ny, nz), (8 * inside + 16 * nbins, 8 * inside))
    walk_report(torch, ck, 18, "shell_bin_values_folded_rows", rows["shell_bin_values_folded_rows"],
                ck.walk_launch("fava_shell_bin_folded_blocks_per_sm", (2, 0), 2, nxh * rows8, nbins),
                "fava_shell_bin_values_folded", padded[0].data_ptr(), padded[1].data_ptr(),
                out3.data_ptr(), nxh, rows8, nzr, nbins, ny, nz, 2)
    del folds, padded, ref, got, k4, out3
    torch.cuda.empty_cache()

    # B12 on sqrt(rho)*v_x and its cuts: the cluster FFT kernel (the
    # power-of-two route at 512^3; the mixed-radix route at 512x512x480 (z =
    # 15 x 16), 512x480x512 (y = 10 x 6 x 8) and 512x384x375 (odd z, rows
    # paired); the chirp route at 512x512x502 (z = 2 x 251: 251 in a
    # 512-point convolution), 512x502x512 (y in 1024), 512x509x509 (both)
    # and 512x512x1 (no z transform)) and the dense kernel, on no route, at
    # 512^3 and 512x512x502 (the time the chirp route replaces) against the
    # float64 dense DFT, each launched once and timed beside one cuFFT rfftn
    # over the y and z axes (the library call). The kernels line's rows
    # hold 512^3; their "shapes" the cuts.
    x = torch.sqrt(dens) * vels[0]
    for line in ptxas_report("zy_fft_kernel", entries=True):  # builds <0> pow2, <1> mixed, <2> chirp
        say(f"phase 18 zy_fft_kernel ptxas: {line}")
    cuts = {"512^3": x, "512x512x480": x[..., :480], "512x480x512": x[:, :480],
            "512x384x375": x[:, :384, :375], "512x512x502": x[..., :502], "512x502x512": x[:, :502],
            "512x509x509": x[:, :509, :509], "512x512x1": x[..., :1]}
    b12 = {}
    for cut, v in cuts.items():
        v = v.contiguous()
        vx, vy, vz = (int(n) for n in v.shape)
        names = ["zy_rfft_planar"]
        if cut in ("512^3", "512x512x502"):
            names.append("zy_rfft_planar_dense")
        plan = ck._zy_fft_plan(vy, vz)
        say(f"phase 18 zy_rfft_planar plan at {cut}: cluster {plan.cluster}, tile {plan.tile}, passes "
            f"{plan.passes}, rows {plan.rows}, row batch {plan.batch}, shared bytes {plan.smem}, active "
            f"clusters {ck.zy_fft_active_clusters(plan)}; radices z {plan.radices_z} y {plan.radices_y}; "
            f"transform lengths z {plan.mz} y {plan.my} (chirp z {plan.chirp_z}, y {plan.chirp_y}, tables in "
            f"{'global' if plan.chirp_global else 'shared'} memory)")
        ref = ck._zy_rfft_plain(v.double())
        scale = max(float(r.abs().max()) for r in ref)
        work = (4 * v.numel() + 8 * vx * vy * (vz // 2 + 1), zy_fft_ops(vx, vy, vz))
        library_ms = cuda_ms(torch, lambda: torch.fft.rfftn(v, dim=(1, 2)), 20)
        for name in names:
            fn = ck.zy_rfft_planar if name == "zy_rfft_planar" else ck._zy_rfft_dense
            ck.reset_launch_counts()
            got = fn(v)
            torch.cuda.synchronize()
            if {k: n for k, n in ck.launch_counts().items() if n} != {name: 1}:
                fail(f"{name} at {cut} launched {ck.launch_counts()}, expected {name} once")
            max_abs = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
            del got
            row = kernel_row(torch, 18, f"{name} at {cut}", max_abs, max_abs / (TOL_ZY * scale),
                             f"{TOL_ZY!r} of the largest coefficient {scale!r}", lambda: fn(v),
                             lambda: ck._zy_rfft_plain(v), work)
            row["library_ms"] = library_ms
            if name == "zy_rfft_planar":
                row.update(plan=dataclasses.asdict(plan), active_clusters=ck.zy_fft_active_clusters(plan))
            b12[name, cut] = row
            say(f"phase 18 {name} at {cut}: {row['ms']!r} ms, bound {row['bound_ms']!r} ms, plain "
                f"{row['plain_ms']!r} ms, library call torch.fft.rfftn(x, dim=(1, 2)) {library_ms!r} ms")
        del ref, v
        torch.cuda.empty_cache()
    for name in ("zy_rfft_planar", "zy_rfft_planar_dense"):
        rows[name] = {**b12[name, "512^3"],
                      "shapes": {cut: r for (n, cut), r in b12.items() if n == name and cut != "512^3"}}
    say("phase 18 library_ms null for B9 and B11: no single PyTorch call bins powers by shell")
    del x
    torch.cuda.empty_cache()

    # The FFT kernel's multi-pass plan: a random (8, 1024, 1024) volume.
    gen = torch.Generator(device=dens.device).manual_seed(18)
    x = torch.randn((8, 1024, 1024), generator=gen, device=dens.device)
    plan = ck._zy_fft_plan(1024, 1024)
    ck.reset_launch_counts()
    got = ck.zy_rfft_planar(x)
    torch.cuda.synchronize()
    if ck.launch_counts()["zy_rfft_planar"] != 1:
        fail(f"zy_rfft_planar at (8, 1024, 1024) did not take the FFT kernel: {ck.launch_counts()}")
    ref = ck._zy_rfft_plain(x.double())
    scale = max(float(r.abs().max()) for r in ref)
    ratio = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref)) / (TOL_ZY * scale)
    say(f"phase 18 zy_rfft_planar (8, 1024, 1024), plan cluster {plan.cluster}, tile {plan.tile}, "
        f"passes {plan.passes}, shared bytes {plan.smem}, active clusters "
        f"{ck.zy_fft_active_clusters(plan)}: error/bound {ratio!r} (bound {TOL_ZY!r} of the largest "
        f"coefficient); {cuda_ms(torch, lambda: ck.zy_rfft_planar(x), 20)!r} ms, torch.fft.rfftn "
        f"{cuda_ms(torch, lambda: torch.fft.rfftn(x, dim=(1, 2)), 20)!r} ms")
    if not ratio <= 1.0:
        fail("zy_rfft_planar's two-pass plan disagrees with the float64 dense DFT")
    del x, got, ref
    torch.cuda.empty_cache()
    return rows


# The shell-binning walk's kernels (csrc/shell_bins.cuh) in the build log:
# the instantiation of each kernels-line row.
WALK_PTXAS = {
    "shell_bin_values_folded": "shell_walk_kernelILi2ELb0ENS_10FoldedRowsELb0E",
    "shell_bin_values_folded_1ch": "shell_walk_kernelILi1ELb0ENS_10FoldedRowsELb0E",
    "shell_bin_sums_folded_onepass": "shell_walk_kernelILi2ELb1ENS_10FoldedRowsELb0E",
    "shell_bin_values_folded_rows": "shell_walk_kernelILi2ELb0ENS_10FoldedRowsELb0E",
    "shell_bin_powers_fused": "powers_fold_bin_kernelILb1ELb0E",
    "shell_bin_sums_unfolded": "shell_walk_kernelILi2ELb0ENS_12UnfoldedRowsELb0E",
    "shell_bin_values_rfft_chunk": "shell_walk_kernelILi2ELb0ENS_12UnfoldedRowsELb0E",
}
# Their wide instantiations (nbins > 4095, phase 20): the same names with
# the last template argument true.
WIDE_PTXAS = {k: v[: -len("Lb0E")] + "Lb1E" for k, v in WALK_PTXAS.items()}


def walk_report(torch, ck, phase, name, row, launch, entry, *args):
    """Print a shell-binning kernel's ptxas report (registers, spills), its
    launch (threads and dynamic shared bytes a block, blocks an SM from the
    occupancy query, the grid), and its time through the C entry alone
    (``entry`` with ``args``, the output already allocated: no checks, no
    allocation or zeroing) beside the wrapper's time in ``row``, each
    against the bound (CUDA events, 20 warm calls)."""
    from fava_tpu_torch.ops import _build

    for line in ptxas_report(WALK_PTXAS[name]):
        say(f"phase {phase} {name} ptxas: {line}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"phase {phase} {name} launch: {32 * launch['warps']} threads and {launch['smem']} shared "
        f"bytes a block, {launch['blocks_per_sm']} blocks an SM "
        f"({launch['blocks_per_sm'] * launch['warps']} warps of 64), grid {launch['blocks']} on {sms} SMs")
    fn = getattr(_build.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*args, launch["blocks"], stream)
        if err:
            fail(f"{name}: C entry {entry} failed with {err}")

    c_ms = cuda_ms(torch, run, 20)
    bound = row["bound_ms"]
    say(f"phase {phase} {name}: C entry {c_ms!r} ms ({c_ms / bound!r} x its bound), wrapper "
        f"{row['ms']!r} ms ({row['ms'] / bound!r} x), bound {bound!r} ms")


def unfolded_launch(torch, ck, shape, full_nz, channels, nbins):
    """B6/B10's launch over the walks of an (nx, ny, nzr) volume: one a row
    of a half-spectrum, two a row of a full grid."""
    nx, ny, nzr = (int(s) for s in shape)
    walks = nx * ny * (2 if nzr == full_nz else 1)
    return ck.walk_launch("fava_shell_bin_unfolded_blocks_per_sm", (channels,), channels, walks, nbins)


def regrid_launch(torch, ck, phase, out_shape, wide):
    """Print K7's ptxas report and launch: threads along z and rows a
    block, blocks an SM (occupancy) and the grid."""
    for line in ptxas_report("regrid_kernel"):
        say(f"phase {phase} regrid_kernel ptxas: {line}")
    nx, ny, nz = out_shape
    tz = ck._regrid_threads(nz)
    bps = ck.regrid_blocks_per_sm(wide)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"phase {phase} regrid_kernel launch on {tuple(out_shape)}: {tz} threads along z x "
        f"{ck.REGRID_THREADS // tz} rows a block, {'wide' if wide else 'narrow'} indices, {bps} "
        f"blocks an SM ({bps * ck.REGRID_THREADS // 32} warps of 64), grid "
        f"{ck._regrid_blocks(nx * ny, tz)} on {sms} SMs")


def ptxas_report(kernel: str, entries: bool = False):
    """The -Xptxas -v lines of the build about ``kernel``: its stack and
    spills, its registers and shared memory (and, with ``entries``, the
    line that names each instantiation)."""
    from fava_tpu_torch.ops import _build

    out, inside = [], False
    for line in (_build.BUILD_LOG or "").splitlines():
        if "Compiling entry" in line:
            inside = kernel in line
            if inside and entries:
                out.append(line.strip())
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def fused_path_ms(torch, fields, nbins, reps=3):
    """Median device ms over ``reps`` warm runs (CUDA events) of each
    spectra path: the total of its entry function, and its two stages,
    timed through the functions the entry composes: (a) the power volumes
    and ops.cuda_kernels.shell_bin_sums_rfft, (m) ops.spectra.rfft_shell_sums,
    (c) experiments.planar_dft.rfft_shell_sums_fused_zy, (d) and (e)
    experiments.folded_bins.rfft_shell_sums_folded."""
    from fava_tpu_torch.experiments import folded_bins, planar_dft
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import spectra

    dens, *vels = fields
    shape = tuple(int(s) for s in dens.shape)
    nz = shape[2]

    def powers_then(binning):
        return lambda ffts: binning(*spectra.rfft_power_volumes(ffts, shape))

    def b9(stacks):
        return ck.shell_bin_powers_fused(*stacks, nbins, nz)

    def folded(binning):
        return (lambda: folded_bins.rfft_shell_sums_folded(dens, vels, nbins, binning),
                lambda: spectra.kinetic_transforms(dens, vels),
                powers_then(lambda t, lo: folded_bins.shell_sums_padded_fold(t, lo, nbins, nz, binning)))

    paths = {
        "a": ((lambda: ck.shell_bin_sums_rfft(*spectra.kinetic_power_volumes(dens, vels), nbins,
                                              nz),
               lambda: spectra.kinetic_transforms(dens, vels),
               powers_then(lambda t, lo: ck.shell_bin_sums_rfft(t, lo, nbins, nz))), "powers_K3_K4"),
        "m": ((lambda: spectra.rfft_shell_sums(dens, vels, nbins),
               lambda: torch.view_as_real(spectra.kinetic_transforms(dens, vels)),
               lambda r: b9((r[..., 0], r[..., 1]))), "B9"),
        "c": ((lambda: planar_dft.rfft_shell_sums_fused_zy(dens, vels, nbins),
               lambda: planar_dft.velocity_transforms_fused_zy(dens, vels), b9), "B9"),
        "d": (folded("onepass"), "powers_K3_pad_B11a"),
        "e": (folded("rows"), "powers_K3_pad_B11b"),
    }
    out = {}
    for key, ((entry, transforms, binning), bin_name) in paths.items():
        samples = []
        for _ in range(reps + 1):  # the first run warms up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            entry()
            ev[1].record()
            spec = transforms()
            ev[2].record()
            binning(spec)
            ev[3].record()
            torch.cuda.synchronize()
            del spec
            samples.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        t = [statistics.median(s[i] for s in samples[1:]) for i in range(3)]
        out[key] = {"total_ms": t[0], "transforms_ms": t[1], f"{bin_name}_ms": t[2]}
    return out


def phase_fused(torch, np, fields, ref_spectra):
    """Phase 18 on phase 3's 512^3 fields: the four kernels against their
    plain versions, then the spectra five ways with counters, held to
    each other and to phase 4's float64 CPU path; stage times."""
    from fava_tpu_torch.experiments import folded_bins, planar_dft
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops.spectra import kinetic_power_volumes, rfft_shell_sums

    dens, *vels = fields
    nx, ny, nz = (int(s) for s in dens.shape)
    nbins = max(nx, ny, nz) // 2 - 1
    rows = fused_kernel_rows(torch, ck, fields, nbins)
    fold_then = {"fold_quadrants_pair": 1}

    runs = {
        "(a) cuFFT, powers, K3, K4": (
            lambda: ck.shell_bin_sums_rfft(*kinetic_power_volumes(dens, vels), nbins, nz),
            {"fold_quadrants_pair": 1, "shell_bin_values_folded": 1}),
        "(m) main path: cuFFT into one stack, B9": (lambda: rfft_shell_sums(dens, vels, nbins),
                                                    {"shell_bin_powers_fused": 1}),
        "(c) B12 and cuFFT along x, B9": (
            lambda: planar_dft.rfft_shell_sums_fused_zy(dens, vels, nbins),
            {"zy_rfft_planar": 3, "shell_bin_powers_fused": 1}),
        "(d) cuFFT, powers, K3, pad8, B11a": (
            lambda: folded_bins.rfft_shell_sums_folded(dens, vels, nbins, "onepass"),
            {**fold_then, "shell_bin_sums_folded_onepass": 1}),
        "(e) cuFFT, powers, K3, pad8, B11b": (
            lambda: folded_bins.rfft_shell_sums_folded(dens, vels, nbins, "rows"),
            {**fold_then, "shell_bin_values_folded": 1}),
    }
    totals, spectra = {}, {}
    for what, (fn, expect) in runs.items():
        (counts, sums), launches = counted(torch, ck, what, fn, tuple(expect), 18)
        if {k: v for k, v in launches.items() if v} != expect:
            fail(f"{what} launched {launches}, expected exactly {expect}")
        add_counts(totals, launches)
        if what.startswith("(e)"):  # B11b is K4's kernel: its row counts K4's launches in (e)
            totals["shell_bin_values_folded_rows"] = launches["shell_bin_values_folded"]
        spectra[what] = {"spectra_counts": counts.cpu().numpy(), "spectra_total": sums[0].cpu().numpy(),
                         "spectra_longitudinal": sums[1].cpu().numpy(),
                         "spectra_transverse": sums[2].cpu().numpy()}
    if not all(np.array_equal(s["spectra_counts"], np.asarray(ref_spectra["spectra_counts"]))
               for s in spectra.values()):
        fail("the spectra paths' counts differ from the float64 path's")
    say(f"phase 18 counts of the {len(spectra)} paths: equal to the float64 path's")
    # Against (a): (m) differs by float32 vs float64 powers, (c) also by B12,
    # (d) and (e) only by the order of the same float64 sums.
    bounds = {"a": TOL_SPECTRA, "m": TOL_SPECTRA, "c": TOL_ZY_PATH, "d": TOL_BIN, "e": TOL_BIN}
    a_key = next(iter(spectra))
    no_counts = {k: v for k, v in spectra[a_key].items() if k != "spectra_counts"}
    ref = {k: v for k, v in ref_spectra.items() if k != "spectra_counts"}
    floor, errs = {}, {}
    for key, out in spectra.items():
        p = key[1]
        if p != "a":
            errs[f"{p}_vs_a"] = compare_flagship(np, out, no_counts, floor, f"{key} vs {a_key}", 18,
                                                 bound_of=lambda k, b=bounds[p]: b)
        errs[f"{p}_vs_float64"] = compare_flagship(
            np, out, ref, floor, f"{key} vs float64", 18,
            bound_of=lambda k, b=max(bounds[p], TOL_SPECTRA): b)
    times = {"stages_ms": fused_path_ms(torch, fields, nbins), "errors": errs}
    for nz in (480, 502):
        times[f"cut_512x512x{nz}"] = cut_route_path(torch, ck, fields, totals, nz, "zy_rfft_planar")
    return rows, totals, times


def cut_route_path(torch, ck, fields, totals, nz, b12):
    """Path (c) on the fields cut to 512x512xnz, where B12 takes ``b12`` (3
    launches): z = 480 = 2^5 x 3 x 5 the cluster FFT kernel's mixed-radix
    route, z = 502 = 2 x 251 its chirp route; held to path (a) on the same
    cut, counts exact; one warm run timed (CUDA events)."""
    from fava_tpu_torch.experiments import planar_dft
    from fava_tpu_torch.ops.spectra import rfft_shell_sums

    dens, *vels = (f[..., :nz].contiguous() for f in fields)
    nbins = max(dens.shape) // 2 - 1
    what = f"(c) on 512x512x{nz}"
    expect = {b12: 3, "shell_bin_powers_fused": 1}
    (counts, sums), launches = counted(
        torch, ck, f"{what}, B12 {b12}", lambda: planar_dft.rfft_shell_sums_fused_zy(dens, vels, nbins),
        tuple(expect), 18)
    if {k: v for k, v in launches.items() if v} != expect:
        fail(f"{what} launched {launches}, expected exactly {expect}")
    add_counts(totals, launches)
    ref_counts, ref_sums = rfft_shell_sums(dens, vels, nbins)
    if not torch.equal(counts, ref_counts):
        fail(f"{what}: counts differ from (a)'s")
    err = float((sums - ref_sums).abs().max() / ref_sums.abs().max())
    say(f"phase 18 {what} vs (a): max|diff|/scale {err!r} (bound {TOL_ZY_PATH!r})")
    if not err <= TOL_ZY_PATH:
        fail(f"{what} disagrees with (a)")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    planar_dft.rfft_shell_sums_fused_zy(dens, vels, nbins)
    end.record()
    torch.cuda.synchronize()
    del dens, vels
    torch.cuda.empty_cache()
    return {"b12": b12, "error_vs_a": err, "total_ms": start.elapsed_time(end)}


# ---------------------------------------------------------------------------
# Phase 19: stage 4's fractal dimension and structure functions on the window


def structure_runs(uni, flm):
    """Stage 4's fractal and structure analyses with the pipeline's defaults (no kernel)."""
    return {
        "fractal dimension": (lambda: flm.fractal_dimension(field="flam", contours=0.5), ()),
        "structure functions": (uni.structure_functions, ()),
        "structure function exponents": (uni.structure_function_exponents, ()),
        "velocity increment pdfs": (uni.velocity_increment_pdfs, ()),
    }


def differing_cells(torch, np, uni):
    """Which draws gather other cells on the card than on the CPU, for
    the pipeline's defaults: {analysis: (share of endpoints, per
    (order, separation) flags)} — ten orders of the structure functions,
    the increment PDFs' one draw."""
    from fava_tpu_torch.ops import structure as st

    vels = [uni.mesh._scalar_volume(f"vel{a}") for a in "xyz"]
    _, shape, lo, width, cell = st._geometry(vels, uni.mesh.domain_bounds)
    out = {}
    for what, seps, points, bases in (
        ("structure functions", st._separations(None, 100, True, cell, width), 10000,
         [3 * o for o in range(10)]),
        ("velocity increment pdfs", st._separations(None, 8, True, cell, width), 65536,
         [st._INC_STREAM]),
    ):
        flags, differ = [], 0
        for base in bases:
            draws = [st._draw_pairs(seps, lo, width, cell, shape, 0, base, points, torch.float64, d)
                     for d in ("cuda", "cpu")]
            moved = sum((a.cpu() != b).any(dim=-1) for a, b in zip(draws[0][3:], draws[1][3:]))
            differ += int(moved.sum())
            flags.append(moved.any(dim=1).numpy())
        out[what] = (differ / (2 * len(bases) * len(seps) * points), np.stack(flags))
    return out


def compare_structure(np, got, ref, ties, what):
    """Hold the fractal and structure results to the float64 CPU path:
    the fractal statistics (built from equal box counts) exactly;
    structure functions, exponents and increment moments within
    TOL_STRUCTURE (moments of max(|ref|, std)), TOL_TIE where a draw of
    that separation gathered another cell (``ties``, differing_cells);
    increment counts within TOL_SHIFT moved samples a tie-free
    separation."""
    worst = {}
    if got["fractal dimension"] != ref["fractal dimension"]:
        fail(f"{what} fractal dimension {got['fractal dimension']} differs from "
             f"{ref['fractal dimension']}")
    sf_ties, pdf_ties = ties["structure functions"][1], ties["velocity increment pdfs"][1][0]

    def held(err, tie):
        return np.where(tie, err / TOL_TIE, err / TOL_STRUCTURE)

    for comp in ("longitudinal", "transverse"):
        for o, r in ref["structure functions"][comp].items():
            err = np.abs(got["structure functions"][comp][o] - r) / np.abs(r)
            worst[f"sf {comp} {o}"] = float(np.max(held(err, sf_ties[int(o) - 1])))
        zeta = np.abs(ref["structure function exponents"][comp]["zeta"])
        for k, r in ref["structure function exponents"][comp].items():
            scale = np.maximum(np.abs(r), zeta)  # a fit's error of the exponent's size
            err = np.abs(got["structure function exponents"][comp][k] - r) / scale
            worst[f"exponents {comp} {k}"] = float(np.max(held(err, sf_ties.any())))
        pg, pr = got["velocity increment pdfs"][comp], ref["velocity increment pdfs"][comp]
        moved = np.abs(pg["counts"] - pr["counts"]).sum(axis=1) / 2
        worst[f"pdf {comp} counts"] = float(np.max(np.where(pdf_ties, 0.0, moved)) / TOL_SHIFT)
        for k in ("mean", "std", "skewness", "flatness"):
            err = np.abs(pg[k] - pr[k]) / np.maximum(np.abs(pr[k]), pr["std"])
            worst[f"pdf {comp} {k}"] = float(np.max(held(err, pdf_ties)))
    top = max(worst, key=worst.get)
    say(f"phase 19 {what} vs the plain float64 path: {len(worst)} arrays, worst error/bound "
        f"{worst[top]!r} ({top}); separations held to TOL_TIE: structure functions "
        f"{int(sf_ties.sum())} of {sf_ties.size}, increment pdfs {int(pdf_ties.sum())} of {pdf_ties.size}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with the plain float64 path (error/bound): {bad}")
    return worst[top]


def phase_fractal_structure(torch, np, workdir: Path, uni, cpu):
    """Phase 19: fractal dimension and structure functions on the window."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import fractal

    flam_dir = workdir / "flam"
    flam_dir.mkdir()
    amr = fava_tpu_torch.FLASH(workdir)
    amr.load(file_type="plt", fields=["flam"])
    t0 = time.perf_counter()
    _, launches = counted(torch, ck, "from_amr flam", lambda: amr.mesh.from_amr(
        subdomain_coords=np.array(AMR_WINDOW), fields=["flam"],
        filename=flam_dir / "rt_hdf5_uniform_0001"), ("regrid_fields",), 19)
    times = {"flam_window_from_amr_with_write_s": time.perf_counter() - t0}
    del amr
    torch.cuda.empty_cache()
    flm = fava_tpu_torch.FLASH(flam_dir)
    flm.load(file_type="uni", fields=["flam"])
    results, walls, totals = run_counted(torch, ck, 19, structure_runs(uni, flm), "window fractal/structure")
    add_counts(totals, launches)
    times["walls_s"] = walls
    for key in ("longitudinal", "transverse"):
        sf = results["structure functions"][key]
        if sorted(sf, key=int) != [f"{o}" for o in range(1, 11)] or not all(
                v.shape == (100,) and np.isfinite(v).all() for v in sf.values()):
            fail(f"structure functions {key}: not ten finite (100,) orders")
        counts = results["velocity increment pdfs"][key]["counts"]
        if counts.shape != (8, 101) or not (counts.sum(axis=1) <= 65536).all():
            fail(f"velocity increment pdfs {key}: counts {counts.shape}")
    fd = results["fractal dimension"]["flam"]["0.5"]
    if not all(np.isfinite(v) for v in fd.values()):
        fail(f"fractal dimension of flam at 0.5 is not finite: {fd}")

    flam = flm.mesh._volume("flam")
    largest = min(flam.shape)
    flength = int(np.log2(largest)) + 1
    boxes = fractal.box_counts(fractal.edge_detect(flam, 0.5), flength)
    times["fractal_boxes"] = boxes.tolist()
    ties = differing_cells(torch, np, uni)
    times["share_of_endpoints_with_other_cells"] = {k: v[0] for k, v in ties.items()}
    say(f"phase 19 flam box counts {boxes.tolist()}; share of draw endpoints whose gathered cell "
        f"differs between the card and the CPU: {times['share_of_endpoints_with_other_cells']}")
    if not max(times["share_of_endpoints_with_other_cells"].values()) <= MAX_TIE_SHARE:
        fail("the card's draws gather other cells than the CPU's beyond ulp-level ties")
    del flam, flm
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flm_cpu = fava_tpu_torch.FLASH(flam_dir, device="cpu")
    flm_cpu.load(file_type="uni", fields=["flam"])
    ref_boxes = fractal.box_counts(fractal.edge_detect(flm_cpu.mesh._volume("flam"), 0.5), flength)
    if not np.array_equal(boxes, ref_boxes):
        fail(f"flam box counts {boxes.tolist()} differ from the float64 path's {ref_boxes.tolist()}")
    ref = {name: fn() for name, (fn, _) in structure_runs(cpu, flm_cpu).items()}
    say(f"phase 19 plain float64 fractal and structure analyses on the CPU: {time.perf_counter() - t0:.1f} s")
    times["errors"] = compare_structure(np, results, ref, ties, "window fractal/structure")
    return times, totals


# ---------------------------------------------------------------------------
# Phase 20: shell binning past 4095 shells (the walk's wide path)


def wide_rows(torch, ck, fields, nbins):
    """Each walk kernel on the wide volume's shapes against its plain
    version (counts exact, TOL_BIN per shell), timed against its bound,
    with its wide instantiation's ptxas report and launch."""
    from fava_tpu_torch.experiments import folded_bins, planar_dft

    dens, *vels = fields
    nx, ny, nz = (int(s) for s in dens.shape)
    nzr = nz // 2 + 1
    static = ck._static_counts((nx, ny, nzr), nbins, nz, dens.device)
    rows = {}

    def check(name, got, ref, kernel_fn, work, counts=None):
        if counts is not None and not (torch.equal(counts[0], counts[1])
                                       and torch.equal(counts[0], static)):
            fail(f"{name} (wide) counts differ from the static counts")
        err = (got - ref).abs()
        ratio = float((err / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
        rows[name] = {"max_abs_err": float(err.max()), "error/bound": ratio,
                      "ms": cuda_ms(torch, kernel_fn, 10), **least_time(*work)}
        say(f"phase 20 {name} at {nbins} shells: {rows[name]}")
        if not ratio <= 1.0:
            fail(f"{name} (wide) disagrees with its plain version (error/bound {ratio!r})")
        for line in ptxas_report(WIDE_PTXAS[name]):
            say(f"phase 20 {name} wide ptxas: {line}")

    total, longi = path_powers(torch, fields)
    folds = ck.fold_quadrants_pair(total, longi)
    inside = inside_cells(ck, folds[0], nbins, full_ny=ny)
    nxh, nyh, _ = folds[0].shape
    launch = ck.walk_launch("fava_shell_bin_folded_blocks_per_sm", (2, 0), 2, nxh * nyh, nbins)
    say(f"phase 20 folded walk launch at {nbins} shells: {launch}")
    check("shell_bin_values_folded", ck.shell_bin_values_folded(*folds, nbins, ny, nz),
          ck._shell_bin_folded_plain(*(f.double() for f in folds), nbins, ny, nz),
          lambda: ck.shell_bin_values_folded(*folds, nbins, ny, nz), (8 * inside + 16 * nbins, 8 * inside))
    check("shell_bin_values_folded_1ch", ck.shell_bin_values_folded_1ch(folds[1], nbins, ny, nz),
          ck._shell_bin_folded_plain(folds[1].double(), None, nbins, ny, nz)[0],
          lambda: ck.shell_bin_values_folded_1ch(folds[1], nbins, ny, nz), (4 * inside + 8 * nbins, 4 * inside))
    padded = [folded_bins.pad_rows8(f, float("nan")) for f in folds]
    ref = ck._onepass_plain(*(p.double() for p in padded), nbins, nx, ny, nz)
    counts, sums = ck.shell_bin_sums_folded_onepass(*padded, nbins, nx, ny, nz)
    check("shell_bin_sums_folded_onepass", sums[:2], ref[1:],
          lambda: ck.shell_bin_sums_folded_onepass(*padded, nbins, nx, ny, nz),
          (8 * inside + 24 * nbins, 8 * inside), (counts, ref[0]))
    check("shell_bin_values_folded_rows",
          torch.stack(ck.shell_bin_values_folded_rows(*padded, nbins, nx, ny, nz)), ref[1:],
          lambda: ck.shell_bin_values_folded_rows(*padded, nbins, nx, ny, nz),
          (8 * inside + 16 * nbins, 8 * inside))
    del folds, padded, ref
    inside = inside_cells(ck, total, nbins, full_nz=nz)
    check("shell_bin_sums_unfolded", ck.shell_bin_sums_unfolded(total, longi, nbins, nz),
          ck._shell_bin_unfolded_plain(total.double(), longi.double(), nbins, nz),
          lambda: ck.shell_bin_sums_unfolded(total, longi, nbins, nz), (8 * inside + 16 * nbins, 8 * inside))
    rows_b6 = nx // 8
    ct, cl = total[:rows_b6].contiguous(), longi[:rows_b6].contiguous()
    inside = inside_cells(ck, ct, nbins, full_nz=nz, kx0=0, full_nx=nx)
    check("shell_bin_values_rfft_chunk", ck.shell_bin_values_rfft_chunk(ct, cl, nbins, nx, nz, 0)[:2],
          ck._shell_bin_unfolded_plain(ct.double(), cl.double(), nbins, nz, 0, nx),
          lambda: ck.shell_bin_values_rfft_chunk(ct, cl, nbins, nx, nz, 0),
          (8 * inside + 24 * nbins, 8 * inside))
    del total, longi, ct, cl
    torch.cuda.empty_cache()
    re, im = planar_dft.velocity_transforms(dens, vels)
    counts, sums = ck.shell_bin_powers_fused(re, im, nbins, nz)
    ref = ck._powers_fused_plain(re.double(), im.double(), nbins, nz)
    inside = inside_cells(ck, re[0], nbins, full_nz=nz)
    check("shell_bin_powers_fused", sums[:2], ref[1:],
          lambda: ck.shell_bin_powers_fused(re, im, nbins, nz), (24 * inside + 24 * nbins, 60 * inside),
          (counts, ref[0]))
    del re, im, ref
    torch.cuda.empty_cache()
    return rows


def phase_wide_walk(torch, np):
    """Phase 20: a (16384, 64, 64) volume, 8191 shells, on the wide walk."""
    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(20)
    dens = 1.0 + 0.5 * torch.rand(WIDE_SHAPE, generator=gen, device="cuda")
    vels = [torch.randn(WIDE_SHAPE, generator=gen, device="cuda") for _ in range(3)]
    fields = [dens, *vels]
    nbins = max(WIDE_SHAPE) // 2 - 1
    if not nbins > ck.SHELL_MAX_BINS:
        fail(f"{WIDE_SHAPE} bins {nbins} shells, within the narrow walk")
    rows = wide_rows(torch, ck, fields, nbins)

    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)))
    runs = {"kinetic energy spectra": (model.kinetic_energy_spectra, ("shell_bin_powers_fused",)),
            "flagship analysis": (model.flagship_analysis, FLAGSHIP_KERNELS)}
    results, walls, totals = run_counted(torch, ck, 20, runs, "16384x64x64")
    check_outputs(np, results["flagship analysis"], WIDE_SHAPE, "single")
    host = [f.cpu() for f in fields]
    del model, fields, dens, vels
    torch.cuda.empty_cache()

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    cpu = fava_tpu_torch.from_arrays(dict(zip(NAMES, host)), device="cpu")
    ref_spec, ref_flag = cpu.kinetic_energy_spectra(), cpu.flagship_analysis()
    say(f"phase 20 plain float64 path on the CPU: {time.perf_counter() - t0:.1f} s")
    if not np.array_equal(np.asarray(results["flagship analysis"]["spectra_counts"]),
                          np.asarray(ref_flag["spectra_counts"])):
        fail("16384x64x64 flagship shell counts differ from the float64 path's")
    errors = {"spectra": compare_stage4(np, {"kinetic energy spectra": results["kinetic energy spectra"]},
                                        {"kinetic energy spectra": ref_spec}, set(), 1.0,
                                        "16384x64x64 spectra", 20),
              "flagship": compare_flagship(np, results["flagship analysis"], ref_flag, host,
                                           "16384x64x64 flagship", 20)}
    del cpu, host
    return rows, {"walls_s": walls, "errors": errors}, totals


# ---------------------------------------------------------------------------
# Phase 21: the pipeline on the card


def window_surface_projection(torch, np, workdir: Path, uni, cpu):
    """Phase 21, on phase 6's files: ``flame_surface`` of the window's flam
    (phase 19's file) and the window's projections (phase 8's file, on
    ``uni`` and its CPU copy ``cpu``) on the card against the float64 CPU
    path; the AMR ``projection`` of the plt file likewise."""
    import fava_tpu_torch

    ratios, walls = {}, {}
    flm = fava_tpu_torch.FLASH(workdir / "flam")
    flm.load(file_type="uni", fields=["flam"])
    flm_cpu = fava_tpu_torch.FLASH(workdir / "flam", device="cpu")
    flm_cpu.load(file_type="uni", fields=["flam"])
    got, ref = flm.flame_surface(field="flam"), flm_cpu.flame_surface(field="flam")
    if not np.array_equal(got["x"], ref["x"]) or got["sigma"].shape != (N,):
        fail(f"flame_surface x or sigma shape differs: {got['sigma'].shape}")
    surf = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in
            ("area", "wrinkling", "max_gradient", "thickness")}
    surf["sigma"] = float(np.abs(got["sigma"] - ref["sigma"]).max() / np.abs(ref["sigma"]).max())
    ratios["flame_surface"] = max(surf.values()) / TOL_SURFACE
    walls["flame_surface_s"] = wall_per_call(torch, lambda: flm.flame_surface(field="flam"), 3)
    say(f"phase 21 window flame_surface: area {got['area']!r}, wrinkling {got['wrinkling']!r}, "
        f"thickness {got['thickness']!r}; vs the float64 CPU path {surf} (bound {TOL_SURFACE!r})")
    del flm, flm_cpu
    torch.cuda.empty_cache()

    def projections(what, card, host, runs):
        for kw in runs:
            got, ref = card.projection(**kw), host.projection(**kw)
            if sorted(got) != sorted(ref) or any(
                    not np.array_equal(got[c], ref[c]) for c in ref if c != "map"):
                fail(f"{what} projection {kw}: keys or coordinates differ")
            err = float(np.abs(got["map"] - ref["map"]).max() / np.abs(ref["map"]).max())
            ratios[f"{what} projection {kw}"] = err / TOL_PROJECTION
            walls[f"{what} projection {kw}"] = wall_per_call(torch, lambda: card.projection(**kw), 3)
            say(f"phase 21 {what} projection {kw}: map {got['map'].shape}, max|diff|/scale vs the "
                f"float64 CPU path {err!r} (bound {TOL_PROJECTION!r})")

    runs = ({"field": "dens", "axis": 0}, {"field": "velx", "axis": 2, "weight": "dens"})
    projections("window", uni, cpu, runs)
    amr = fava_tpu_torch.FLASH(workdir)
    amr.load(file_type="plt", fields=["dens", "velx"])
    amr_cpu = fava_tpu_torch.FLASH(workdir, device="cpu")
    amr_cpu.load(file_type="plt", fields=["dens", "velx"])
    projections("AMR", amr.mesh, amr_cpu.mesh, runs)
    del amr, amr_cpu
    torch.cuda.empty_cache()
    if not max(ratios.values()) <= 1.0:
        fail(f"flame_surface or a projection disagrees with the float64 CPU path: {ratios}")
    return {"walls_s": walls, "error_over_bound": ratios}


def pipe_field_fns(torch, xf):
    """The fields of scripts/tpu_pipeline_bench.py's snapshot with its front
    at x = xf, evaluated on the card: a sigmoid progress variable at xf and
    a turbulent brush whose amplitude peaks on the front (so stage 1's
    Ryy + Rzz profile is a bump the fit converges on); pres as
    io/synthetic.py's default."""
    two_pi = 2.0 * math.pi

    def flam(x, y, z):
        return torch.sigmoid(-(x - xf) / 0.02)

    def amp(x):
        return 0.2 + torch.exp(-(((x - xf) / 0.15) ** 2))

    fns = {
        "flam": flam,
        "dens": lambda x, y, z: (1.0 + 0.5 * torch.sin(two_pi * x) * torch.cos(two_pi * y)
                                 + 0.6 * flam(x, y, z)),
        "pres": lambda x, y, z: 2.0 + 0.5 * torch.sin(two_pi * x) * torch.cos(two_pi * z),
        "temp": lambda x, y, z: 1.0 + 2.0 * flam(x, y, z),
        "velx": lambda x, y, z: amp(x) * 0.5 * torch.sin(two_pi * y) * torch.cos(two_pi * z),
        "vely": lambda x, y, z: amp(x) * torch.sin(two_pi * z + 0.5 * torch.cos(two_pi * x)),
        "velz": lambda x, y, z: amp(x) * torch.cos(two_pi * y + 0.3 * torch.sin(two_pi * x)),
    }

    def on_device(fn):
        def run(x, y, z):
            xyz = (torch.from_numpy(a).cuda() for a in (x, y, z))
            return fn(*xyz).float().cpu().numpy()

        return run

    return {name: on_device(fn) for name, fn in fns.items()}


def pipe_series(torch, data: Path, times, xf0, speed, refine_of, fields, **tree):
    """One plt file a time of the series (io/synthetic.make_amr_file), its
    front at xf0 + speed * t and its tree refined by ``refine_of(xf)``."""
    from fava_tpu_torch.io import synthetic

    data.mkdir(parents=True)
    for i, t in enumerate(times, start=1):
        xf = xf0 + speed * t
        synthetic.make_amr_file(data / f"rt_hdf5_plt_cnt_{i:04d}", refine_fn=refine_of(xf),
                                fields=fields, field_fns=pipe_field_fns(torch, xf), time=t, **tree)


def pipe_bands(xf):
    """Phase 6's refined bands moved with the front from x = 2 to xf."""
    bands = tuple((lo + xf - 2.0, hi + xf - 2.0, level) for lo, hi, level in AMR_LEVELS)

    def refine(bounds, level):
        lo, hi = bounds[0]
        for band_lo, band_hi, target in bands:
            if hi > band_lo and lo < band_hi:
                return target
        return AMR_BASE_LEVEL

    return refine


def bench_band(xf):
    """scripts/tpu_pipeline_bench.py's tree at N = 128: level 2 around the
    front (the window's extent), level 1 elsewhere."""
    def refine(bounds, level):
        return 2 if bounds[0, 1] > xf - 0.5 and bounds[0, 0] < xf + 0.5 else 1

    return refine


def pipe_settings(work: Path, data: Path, half_width, structure, extra):
    settings = {
        "data folder": str(data),
        "output folder": str(work / "out"),
        "basename": "rt_hdf5_plt_cnt",
        "dimension": 3,
        "model": "synthetic rtflame",
        "reynolds stress": {"skip": False},
        "extract windows": {"skip": False},
        "flame window": {"half width": half_width, "transverse": [0.0, 1.0]},
        "fractal dimension": {"skip": False, "settings": {"field": "flam", "contours": 0.5}},
        "kinetic energy spectra": {"skip": False},
        "structure functions": {"skip": False, "settings": structure},
        **extra,
    }
    (work / "pipeline_settings.json").write_text(json.dumps(settings, indent=2))
    return settings


class StampedLines:
    """A stdout that passes writes through and keeps each line with the
    host time it was printed."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, text):
        self.out.write(text)
        *done, self._part = (self._part + text).split("\n")
        now = time.perf_counter()
        self.lines.extend((now, line) for line in done)
        return len(text)

    def flush(self):
        self.out.flush()


def stage_walls(lines, t_end):
    """Seconds from each stage's work line (one per snapshot) to the next
    work line or the end: as scripts/tpu_pipeline_bench.py times them, from
    the pipeline's own prints (stage 2 lies in the last stage-1 span)."""
    marks = [(t, line) for t, line in lines if line.startswith(PIPE_WORK_LINES)]
    walls = {}
    for (t, line), (t_next, _) in zip(marks, marks[1:] + [(t_end, "")]):
        if line.startswith("[stage"):
            walls.setdefault(line[1:8], []).append(t_next - t)
    return walls


def h5_datasets(node, prefix=""):
    """Every dataset under an h5lite group, by its path."""
    from fava_tpu_torch.io import h5lite

    out = {}
    for key in node:
        child = node[key]
        if isinstance(child, h5lite.Group):
            out.update(h5_datasets(child, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = child[()]
    return out


def flat_results(np, results, prefix=""):
    out = {}
    for key, value in results.items():
        if isinstance(value, dict):
            out.update(flat_results(np, value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def same_datasets(np, got, ref, what):
    """Dataset by dataset: floats within TOL_RERUN of max(largest |value|, 1)
    (a mean that is rounding noise about 0 has no scale of its own),
    everything else equal. Returns the worst error/bound."""
    if sorted(got) != sorted(ref):
        fail(f"{what}: datasets {sorted(set(got) ^ set(ref))} are not in both")
    worst, worst_key = 0.0, None
    for key, r in ref.items():
        g, r = np.asarray(got[key]), np.asarray(r)
        if r.dtype.kind == "U":
            r = r.astype("S")
        if g.shape != r.shape:
            fail(f"{what} {key}: shape {g.shape} vs {r.shape}")
        if r.dtype.kind != "f":
            if not np.array_equal(g, r):
                fail(f"{what} {key}: not equal")
            continue
        if not np.array_equal(np.isnan(g), np.isnan(r)):
            fail(f"{what} {key}: NaN in other places")
        keep = ~np.isnan(r)
        scale = max(float(np.abs(r[keep]).max(initial=0.0)), 1.0)
        err = float(np.abs(g[keep] - r[keep]).max(initial=0.0)) / (TOL_RERUN * scale)
        if err > worst:
            worst, worst_key = err, key
    if not worst <= 1.0:
        fail(f"{what}: {worst_key} error/bound {worst!r}")
    return worst


def digests(directory: Path):
    import hashlib

    out = {}
    for path in sorted(directory.iterdir()):
        with path.open("rb") as f:
            out[path.name] = hashlib.file_digest(f, "sha1").hexdigest()
    return out


def run_cli(work: Path, **popen):
    """``python -m fava_tpu_torch`` in ``work``, on the card (its default)."""
    env = dict(os.environ, PYTHONPATH=str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", "fava_tpu_torch"], cwd=work, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **popen)


def pipeline_cold(torch, np, work: Path):
    """21a: the two-snapshot series at full width, stages 1 -> 4 in process."""
    import logging

    import fava_tpu_torch
    from fava_tpu_torch import pipeline
    from fava_tpu_torch.io import h5lite
    from fava_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    pipe_series(torch, work / "data", PIPE_TIMES, PIPE_XF0, PIPE_SPEED, pipe_bands,
                PIPE_FIELDS, ncells=AMR_NCELLS, nblks=AMR_NBLKS, domain=np.array(AMR_DOMAIN))
    times = {"synthesis_and_write_s": time.perf_counter() - t0,
             "plt_GB": [p.stat().st_size / 1e9 for p in sorted((work / "data").iterdir())]}
    say(f"phase 21a plt series: {times}")
    settings = pipe_settings(work, work / "data", PIPE_HALF_WIDTH, PIPE_STRUCTURE, PIPE_EXTRA)

    records = []
    catch = logging.Handler()
    catch.emit = records.append
    logger = logging.getLogger("fava_tpu_torch.pipeline.pipeline")
    logger.addHandler(catch)
    stamped = StampedLines(sys.stdout)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sys.stdout = stamped
    try:
        rc = pipeline.main(work)
        torch.cuda.synchronize()
    finally:
        sys.stdout = stamped.out
        logger.removeHandler(catch)
    t_end = time.perf_counter()
    launches = ck.launch_counts()
    times.update({"cold_wall_s": t_end - t0, "stage_walls_s": stage_walls(stamped.lines, t_end)})
    say(f"phase 21a pipeline.main: rc {rc}, {times['cold_wall_s']!r} s, stage walls "
        f"{times['stage_walls_s']}, launches {({k: v for k, v in launches.items() if v})}")
    if rc != 0:
        fail(f"pipeline.main returned {rc}")
    if any("flame_window fit failed" in r.getMessage() for r in records):
        fail("the stage-1 flame_window fit failed and fell back to the stress peak")
    missing = [k for k in PIPE_KERNELS if not launches[k]]
    if missing:
        fail(f"the pipeline launched no {missing}")

    out = work / "out"
    anl = sorted(out.glob("*hdf5_analysis_????"))
    uni = sorted(out.glob("*hdf5_uniform_????"))
    if len(anl) != len(PIPE_TIMES) or len(uni) != len(PIPE_TIMES):
        fail(f"outputs: {len(anl)} analysis and {len(uni)} uniform files")
    for path in uni:
        with h5lite.File(path) as f:
            shapes = {name: f[name].shape[-3:][::-1] for name in PIPE_FIELDS}
        if set(shapes.values()) != {PIPE_WINDOW}:
            fail(f"{path.name}: fields {shapes}, expected {PIPE_WINDOW}")
    state = json.loads((work / "fava.checkpoint").read_text())
    n = len(PIPE_TIMES)
    expect = {"reynolds stress": {"index": n}, "extract windows": {"index": n},
              "analyze uniform data": {"analysis": None, "index": n}}
    if {k: state.get(k) for k in expect} != expect or state.get("settings") != settings:
        fail(f"checkpoint {({k: state.get(k) for k in expect})}, expected {expect}")

    dx = (AMR_DOMAIN[0][1] - AMR_DOMAIN[0][0]) / (
        AMR_NCELLS[0] * AMR_NBLKS[0] * 2 ** (max(lv for *_, lv in AMR_LEVELS) - 1))
    offsets = []
    for path, t in zip(anl, PIPE_TIMES):
        with h5lite.File(path) as f:
            right = f["scalars/window right"][()]
        offsets.append(float((right[0] - PIPE_HALF_WIDTH - (PIPE_XF0 + PIPE_SPEED * t)) / dx))
    times["centroid_minus_front_cells"] = offsets
    say(f"phase 21a stage-1 centroids minus x_f(t), in finest cells: {offsets} "
        f"(bound {PIPE_FIT_CELLS})")
    if not max(abs(o) for o in offsets) <= PIPE_FIT_CELLS:
        fail("a fitted centroid lies off the front")

    model = fava_tpu_torch.FLASH(out)
    worst = 0.0
    for i, path in enumerate(anl):
        model.load(file_index=i, file_type="uni")
        with h5lite.File(path) as f:
            stored = h5_datasets(f)
        if set(k.split("/")[0] for k in stored) != {"reynolds stresses", "scalars", *PIPE_STAGE4}:
            fail(f"{path.name} holds {sorted(set(k.split('/')[0] for k in stored))}")
        again = {}
        for name, method in PIPE_STAGE4.items():
            kwargs = settings[name].get("settings", {})
            again.update(flat_results(np, {name: getattr(model, method)(**kwargs)}))
        stage4 = {k: v for k, v in stored.items() if k.split("/")[0] in PIPE_STAGE4}
        worst = max(worst, same_datasets(np, again, stage4, f"{path.name} stage 4 run again"))
    times["stage4_rerun_error_over_bound"] = worst
    say(f"phase 21a stage-4 datasets of both analysis files equal the analyses run again on the "
        f"extracted files: worst error/bound {worst!r}")
    del model
    torch.cuda.empty_cache()
    return launches, times


def pipeline_resumed(work: Path):
    """21b: ``python -m fava_tpu_torch`` again in the same directory."""
    before = digests(work / "out")
    state = json.loads((work / "fava.checkpoint").read_text())
    t0 = time.perf_counter()
    proc = run_cli(work)
    stdout, _ = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    work_lines = [line for line in stdout.splitlines()
                  if line.startswith("[stage") and "window exists" not in line]
    say(f"phase 21b python -m fava_tpu_torch resumed: rc {proc.returncode}, {wall!r} s, "
        f"work lines {work_lines}")
    if proc.returncode != 0:
        fail(f"the resumed run failed:\n{stdout[-4000:]}")
    if work_lines or "pipeline complete" not in stdout:
        fail("the resumed run did work again")
    if digests(work / "out") != before or json.loads((work / "fava.checkpoint").read_text()) != state:
        fail("the resumed run changed an output or the checkpoint")
    say(f"phase 21b outputs byte-identical ({len(before)} files), checkpoint unchanged")
    return wall


def pipeline_interrupted(torch, np, work: Path):
    """21c: a fresh three-snapshot series as PIPELINE_128.json's, SIGINT
    twice after the first [stage 4] line, the checkpoint read, then resumed
    to its end and held to an uninterrupted run's outputs."""
    import signal

    from fava_tpu_torch import pipeline
    from fava_tpu_torch.io import h5lite

    pipe_series(torch, work / "data", SMALL_TIMES, SMALL_XF0, SMALL_SPEED, bench_band,
                SMALL_FIELDS, ncells=SMALL_NCELLS, nblks=SMALL_NBLKS, domain=np.array(AMR_DOMAIN))
    pipe_settings(work, work / "data", PIPE_HALF_WIDTH, PIPE_STRUCTURE, {})
    ckpt = work / "fava.checkpoint"
    t0 = time.perf_counter()
    proc = run_cli(work)
    sent, lines = 0, []
    for line in proc.stdout:
        lines.append(line.rstrip("\n"))
        if sent == 0 and line.startswith("[stage 4]"):
            proc.send_signal(signal.SIGINT)
            sent = 1
        elif sent == 1 and line.startswith("Calling external handler"):
            # The first SIGINT writes the checkpoint right after this line and
            # restores the default handlers; the second kills the run, as a
            # second Ctrl-C does.
            time.sleep(0.05)
            proc.send_signal(signal.SIGINT)
            sent = 2
    rc = proc.wait(timeout=600)
    times = {"interrupted_wall_s": time.perf_counter() - t0, "interrupted_rc": rc}
    state = json.loads(ckpt.read_text())
    n = len(SMALL_TIMES)
    s4 = state.get("analyze uniform data", {})
    say(f"phase 21c interrupted run: rc {rc}, checkpoint stages 1/3 "
        f"{state.get('reynolds stress')}/{state.get('extract windows')}, stage 4 {s4}")
    if sent != 2 or rc == 0:
        fail(f"the run was not interrupted in stage 4:\n" + "\n".join(lines[-40:]))
    if (state.get("reynolds stress"), state.get("extract windows")) != ({"index": n}, {"index": n}) \
            or not s4.get("index", 0) < n:
        fail(f"checkpoint after the interrupt: {state}")

    t0 = time.perf_counter()
    proc = run_cli(work)
    stdout, _ = proc.communicate(timeout=600)
    times["resume_wall_s"] = time.perf_counter() - t0
    if proc.returncode != 0 or "pipeline complete" not in stdout:
        fail(f"the resume after the interrupt failed (rc {proc.returncode}):\n{stdout[-4000:]}")

    ref = work.parent / "uninterrupted"
    ref.mkdir()
    pipe_settings(ref, work / "data", PIPE_HALF_WIDTH, PIPE_STRUCTURE, {})
    with contextlib.redirect_stdout(io.StringIO()):
        rc = pipeline.main(ref)
    if rc != 0:
        fail("the uninterrupted run failed")
    worst = 0.0
    got_files = sorted(p.name for p in (work / "out").glob("*hdf5_*_????"))
    if got_files != sorted(p.name for p in (ref / "out").glob("*hdf5_*_????")) \
            or len(got_files) != 2 * n:
        fail(f"outputs after the resume: {got_files}")
    for name in got_files:
        with h5lite.File(work / "out" / name) as f, h5lite.File(ref / "out" / name) as g:
            worst = max(worst, same_datasets(np, h5_datasets(f), h5_datasets(g), name))
    times["resumed_vs_uninterrupted_error_over_bound"] = worst
    say(f"phase 21c resumed to rc 0 in {times['resume_wall_s']!r} s; its {len(got_files)} files "
        f"hold the uninterrupted run's datasets (worst error/bound {worst!r})")
    return times


def phase_pipeline(torch, np):
    """Phase 21: the pipeline on the card (21a-c), in its own directory."""
    with tempfile.TemporaryDirectory(prefix="fava_pipe_") as tmp:
        work = Path(tmp) / "run"
        launches, times = pipeline_cold(torch, np, work)
        times["resumed_wall_s"] = pipeline_resumed(work)
        shutil.rmtree(work)
        times.update(pipeline_interrupted(torch, np, Path(tmp) / "interrupt"))
    return launches, times


# ---------------------------------------------------------------------------
# Phase 24: the particle analyses over a 1,000,000-tracer series

PRT_N = 1_000_000
PRT_SNAPSHOTS = 9
PRT_OMEGA = 2.0 * math.pi
PRT_USCALE = 0.1
PRT_NPAIRS = 1024
EUL_SAMPLES = 65536
EUL_SPEED = 0.5
# Float64 on both sides, sums in another order.
TOL_PRT = 1e-12
# The pair moments against the float64 host oracle (powers up to 10 of
# increments summed in another order).
TOL_PAIR_MOMENTS = 1e-9


def on_card(t) -> bool:
    return t.device.type == "cuda"


def prt_tables(np, npart: int, seed: int = 0):
    """Tag-keyed kinematics (scripts/tpu_particles_bench.py): per tag a
    phase phi (3,), a start x0 (3,) and a drift u = USCALE cos(phi); at
    time t, x = x0 + u t and v = cos(OMEGA t + phi). Row i is tag i+1."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0.0, 2.0 * np.pi, size=(npart, 3))
    x0 = rng.uniform(0.0, 1.0, size=(npart, 3))
    return phases, x0, PRT_USCALE * np.cos(phases)


def prt_snapshot(np, phases, x0, u, t):
    return x0 + u * t, np.cos(PRT_OMEGA * t + phases)


def prt_write_series(np, data: Path, tables, times, seed: int = 1):
    """One part file a snapshot, the rows in a fresh permutation each."""
    from fava_tpu_torch.io import flash_file

    phases, x0, u = tables
    npart = x0.shape[0]
    rng = np.random.default_rng(seed)
    tags = np.arange(1, npart + 1, dtype=np.float64)
    for i, t in enumerate(times, start=1):
        pos, vel = prt_snapshot(np, phases, x0, u, t)
        perm = rng.permutation(npart)
        table = {"tag": tags[perm]}
        for a, axis in enumerate("xyz"):
            table[f"pos{axis}"] = pos[perm, a]
        for a, axis in enumerate("xyz"):
            table[f"vel{axis}"] = vel[perm, a]
        flash_file.write_particle_file(
            data / f"rt_hdf5_part_{i:04d}",
            int_scalars={"dimensionality": 3, "globalnumparticles": npart},
            real_scalars={"time": float(t), "dt": 1.0e-3, "dtold": 1.0e-3},
            particles=table,
        )


def hold_close(np, got, ref, what, rtol=0.0, atol=0.0):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"phase 24 {what}: shape {got.shape} against {ref.shape}, or not finite")
    err = np.abs(got - ref)
    if not (err <= atol + rtol * np.abs(ref)).all():
        worst = float(np.max(err / np.maximum(atol + rtol * np.abs(ref), 1e-300)))
        fail(f"phase 24 {what}: max |diff| {float(err.max())!r} ({worst!r} of the tolerance)")
    return float(err.max())


def warm(torch, fn, walls, name):
    """Call ``fn`` twice; the second call's wall goes into ``walls``;
    both results come back."""
    first = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = fn()
    torch.cuda.synchronize()
    walls[f"{name}_s"] = time.perf_counter() - t0
    return first, second


def same_result(np, a, b, what):
    """Two runs of one analysis on the same files are identical (the
    sums are float64 in a fixed order, the draws counter-based)."""
    if isinstance(b, dict):
        for k in b:
            same_result(np, a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_result(np, x, y, f"{what}[{i}]")
    elif not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True):
        fail(f"phase 24 {what}: a second run differs")


def pair_oracle(np, pos, vel, idx, lo, hi, nbins, orders, lengths):
    """Float64 numpy on the given pair draws: counts and mean moments per
    bin, r^2 against the squared edges as the port decides."""
    from fava_tpu_torch.ops.structure import pair_bin_edges

    dr = pos[idx[1]] - pos[idx[0]]
    if lengths is not None:
        L = np.asarray(lengths, dtype=np.float64)
        dr = dr - L * np.round(dr / L)
    r2 = dr[:, 0] * dr[:, 0] + dr[:, 1] * dr[:, 1] + dr[:, 2] * dr[:, 2]
    e2 = pair_bin_edges(lo, hi, nbins, True) ** 2
    keep = (r2 >= e2[0]) & (r2 <= e2[nbins])
    dr, r2 = dr[keep], r2[keep]
    bidx = np.searchsorted(e2[1:nbins], r2, side="right")
    r = np.sqrt(r2)
    dv = vel[idx[1][keep]] - vel[idx[0][keep]]
    dl = np.abs((dv * dr).sum(axis=-1) / np.maximum(r, 1e-30))
    dt = np.sqrt(np.maximum((dv * dv).sum(axis=-1) - dl * dl, 0.0))
    counts = np.bincount(bidx, minlength=nbins).astype(np.float64)
    safe = np.maximum(counts, 1)
    out = {"counts": counts, "separations": np.bincount(bidx, weights=r, minlength=nbins) / safe,
           "longitudinal": {}, "transverse": {}}
    for o in range(1, orders + 1):
        out["longitudinal"][f"{o}"] = np.bincount(bidx, weights=dl**o, minlength=nbins) / safe
        out["transverse"][f"{o}"] = np.bincount(bidx, weights=dt**o, minlength=nbins) / safe
    return out


def hold_pairs(np, got, ref, what):
    if not np.array_equal(got["counts"], ref["counts"]):
        bad = int(np.sum(got["counts"] != ref["counts"]))
        fail(f"phase 24 {what}: counts differ from the float64 oracle in {bad} bins")
    full = ref["counts"] > 0
    hold_close(np, got["separations"][full], ref["separations"][full], f"{what} separations",
               rtol=TOL_PAIR_MOMENTS)
    for comp in ("longitudinal", "transverse"):
        for o, r in ref[comp].items():
            hold_close(np, got[comp][o][full], r[full], f"{what} {comp} {o}", rtol=TOL_PAIR_MOMENTS)
    return int(ref["counts"].sum())


def eulerian_series(np, data: Path, translating: bool):
    """Three plt files on a tree of 288 leaves (a 4^3 root grid, the
    roots over 0.25 < x < 0.75 refined once; 16^3 cells a block): dens
    either static or 2 + cos(2 pi (x - U t))."""
    from fava_tpu_torch.io import synthetic

    def refine(bounds, level):
        return 2 if bounds[0, 1] > 0.25 and bounds[0, 0] < 0.75 else 1

    for i, t in enumerate((0.0, 0.5, 1.0), start=1):
        fns = None
        if translating:
            fns = {"dens": lambda x, y, z, t=t: 2.0 + np.cos(2.0 * np.pi * (x - EUL_SPEED * t))}
        synthetic.make_amr_file(data / f"rt_hdf5_plt_cnt_{i:04d}", ncells=(16, 16, 16), nblks=(4, 4, 4),
                                refine_fn=refine, field_fns=fns, time=t)


def phase_particles(torch, np, card: str):
    """Phase 24: a 1,000,000-tracer series of 9 part files through the six
    particle analyses on the card, each held to its oracle and timed warm."""
    import fava_tpu_torch
    from fava_tpu_torch.analysis import dispersion as disp
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops.structure import pair_indices

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    walls = {}
    times = [0.1 * k for k in range(PRT_SNAPSHOTS)]
    with tempfile.TemporaryDirectory(prefix="fava_prt_") as tmp:
        data = Path(tmp) / "prt"
        data.mkdir()
        # a. the series
        tables = prt_tables(np, PRT_N)
        phases, x0, u = tables
        t0 = time.perf_counter()
        prt_write_series(np, data, tables, times)
        walls["write_s"] = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in data.iterdir())
        say(f"phase 24a: {PRT_SNAPSHOTS} part files of {PRT_N} tracers, {nbytes} bytes, "
            f"written in {walls['write_s']!r} s")
        model = fava_tpu_torch.FLASH(data)

        # b. load, statistics, the particle series
        t0 = time.perf_counter()
        model.load(file_type="prt")
        walls["load_first_s"] = time.perf_counter() - t0
        model.load(file_type="prt")
        walls["load_s"] = time.perf_counter() - t0 - walls["load_first_s"]
        reduced = []
        column = model.particles.device_column
        model.particles.device_column = lambda f: reduced.append(column(f)) or reduced[-1]
        stats = model.particles.statistics()
        del model.particles.device_column
        if sorted(stats) != ["posx", "posy", "posz", "velx", "vely", "velz"]:
            fail(f"phase 24b statistics: fields {sorted(stats)}")
        if not reduced or not all(on_card(c) and c.dtype == torch.float64 for c in reduced):
            fail(f"phase 24b statistics: reduced {[(str(c.device), c.dtype) for c in reduced]}")
        del reduced
        for f, st in stats.items():
            a = "xyz".index(f[-1])
            col = prt_snapshot(np, phases, x0, u, 0.0)[0 if f.startswith("pos") else 1][:, a]
            ref = {"mean": col.mean(), "rms": col.std(), "min": col.min(), "max": col.max()}
            for key in ref:
                hold_close(np, st[key], ref[key], f"statistics {f} {key}", rtol=TOL_PRT)
        vel_fields = ["velx", "vely", "velz"]
        first, series = warm(torch, lambda: model.particle_series(fields=vel_fields), walls,
                             "particle_series")
        same_result(np, first, series, "particle_series")
        hold_close(np, series["times"], times, "particle_series times", rtol=TOL_PRT)
        for a, f in enumerate(vel_fields):
            vel = np.stack([prt_snapshot(np, phases, x0, u, t)[1][:, a] for t in times])
            ref = {"mean": vel.mean(axis=1), "rms": vel.std(axis=1), "min": vel.min(axis=1),
                   "max": vel.max(axis=1)}
            for key, r in ref.items():
                hold_close(np, series[f"{f}_{key}"], r, f"particle_series {f}_{key}", rtol=TOL_PRT)
        say(f"phase 24b: statistics on the card (float64 columns), particle_series held to "
            f"float64 numpy (rtol {TOL_PRT})")

        # c. the Lagrangian autocorrelation against the closed form
        lag_fields = ["velx", "vely"]
        first, (lag_t, lag) = warm(
            torch, lambda: model.lagrangian_autocorrelation(nsamples=PRT_N, fields=lag_fields), walls,
            "lagrangian_autocorrelation")
        same_result(np, first, (lag_t, lag), "lagrangian_autocorrelation")
        v0 = prt_snapshot(np, phases, x0, u, 0.0)[1]
        lag_err = 0.0
        for a, f in enumerate(lag_fields):
            ref = []
            for t in times:
                v = prt_snapshot(np, phases, x0, u, t)[1][:, a]
                ref.append(np.sum(v0[:, a] * v) / (np.linalg.norm(v0[:, a]) * np.linalg.norm(v)))
            lag_err = max(lag_err, hold_close(np, lag[f], ref, f"lagrangian_autocorrelation {f}",
                                              atol=TOL_PRT))
        hold_close(np, lag_t, times, "lagrangian times", rtol=TOL_PRT)

        # d. the cross correlation, whole series and a window
        sample_tags = np.arange(2, 2 * 1024 + 2, 2, dtype=np.float64)
        poi = 777.0
        kw = dict(lagrangian_tracking=True, tag_field="tag")
        cross_err = 0.0
        for name, win in (("cross_correlation", {}), ("cross_correlation_window", {"ibeg": 2, "iend": 7})):
            first, rho = warm(torch, lambda: model.cross_correlation(
                "velx", "vely", sample_points=sample_tags, poi_idx=poi, **win, **kw), walls, name)
            same_result(np, first, rho, name)
            sel = times[win.get("ibeg", 0):win.get("iend", PRT_SNAPSHOTS)]
            vels = [prt_snapshot(np, phases, x0, u, t)[1] for t in sel]
            samp = np.stack([v[(sample_tags - 1).astype(np.int64), 0] for v in vels])
            temp = np.array([[v[int(poi) - 1, 1]] for v in vels])
            rts = np.sum(temp[1:] * samp[:-1], axis=0) / float(len(sel) - 1)
            ref = (rts - samp[:-1].mean(axis=0) * temp[1:].mean()) / (samp[:-1].std(axis=0) * temp[1:].std())
            cross_err = max(cross_err, hold_close(np, rho, ref, name, atol=TOL_PRT))

        # e. dispersion: partners against scipy's cKDTree, MSDs against the construction
        from scipy.spatial import cKDTree

        first, dsp = warm(torch, lambda: model.dispersion_statistics(npairs=PRT_NPAIRS), walls,
                          "dispersion_statistics")
        same_result(np, first, dsp, "dispersion_statistics")
        anchors = np.random.default_rng(0).choice(PRT_N, size=PRT_NPAIRS, replace=False)
        t0 = time.perf_counter()
        _, nn = cKDTree(x0).query(x0[anchors], k=2)
        walls["kdtree_oracle_s"] = time.perf_counter() - t0
        kd_partners = np.where(nn[:, 0] == anchors, nn[:, 1], nn[:, 0])
        dev = model.particles.device
        partners = disp._nearest_neighbor_pairs(x0, anchors, dev)
        if not np.array_equal(partners, kd_partners):
            fail(f"phase 24e: {int(np.sum(partners != kd_partners))} of {PRT_NPAIRS} partners differ "
                 "from cKDTree's")
        c = torch.as_tensor(np.ascontiguousarray(x0.T), device=dev)
        a = torch.as_tensor(anchors, device=dev)
        walls["nn_sweep_ms"] = cuda_ms(torch, lambda: disp.nn_sweep(c, a), 3)
        del c, a
        hold_close(np, dsp["single_msd"], [np.sum(u**2, axis=1).mean() * t**2 for t in times],
                   "single_msd", rtol=TOL_PRT)
        pair_ref = []
        for t in times:
            pos = prt_snapshot(np, phases, x0, u, t)[0]
            pair_ref.append(((pos[anchors] - pos[kd_partners]) ** 2).sum(axis=1).mean())
        hold_close(np, dsp["pair_msd"], pair_ref, "pair_msd", rtol=TOL_PRT)
        if dsp["npairs"] != PRT_NPAIRS:
            fail(f"phase 24e: npairs {dsp['npairs']}")
        # The host pieces a tracked snapshot pays: the loader's sort of a
        # permuted tag column, then rows_for_tags on the sorted one.
        from fava_tpu_torch.mesh.flash_particles import rows_for_tags

        raw = np.random.default_rng(3).permutation(PRT_N).astype(np.float64) + 1.0
        t0 = time.perf_counter()
        tags = raw[np.argsort(raw)]
        walls["tag_sort_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows_for_tags(tags, tags)
        walls["rows_for_tags_s"] = time.perf_counter() - t0
        del raw, tags

        # f. pair structure functions against the float64 host oracle
        model.load(file_index=0, file_type="prt")
        pos, vel = model.particles.get_coords(), np.stack(
            [model.particles.data[f"vel{a}"] for a in "xyz"], axis=-1)
        pairs = {}
        for name, kwp in (("pairs_default", {}),
                          ("pairs_periodic", {"lengths": (1.0, 1.0, 1.0), "num_pairs": 4_194_304})):
            # float64 atomics: the warm run's sums may differ in their last bits.
            _, got = warm(torch, lambda: model.particle_structure_functions(**kwp), walls, name)
            span = pos.max(axis=0) - pos.min(axis=0)
            hi = float(np.min(span[span > 0])) / 2.0
            lo = hi / max(PRT_N ** (1.0 / 3.0), 2.0)
            t0 = time.perf_counter()
            idx = pair_indices(0, kwp.get("num_pairs", 200000), PRT_N, device="cpu").numpy().astype(np.int64)
            ref = pair_oracle(np, pos, vel, idx, lo, hi, 24, 10, kwp.get("lengths"))
            walls[f"{name}_oracle_s"] = time.perf_counter() - t0
            pairs[name] = hold_pairs(np, got, ref, name)
        del pos, vel

        # g. the Eulerian autocorrelation over plt series (static, translating)
        for name, translating in (("eulerian_static", False), ("eulerian_translating", True)):
            edir = Path(tmp) / name
            edir.mkdir()
            eulerian_series(np, edir, translating)
            emodel = fava_tpu_torch.FLASH(edir)
            first, (et, eres) = warm(torch, lambda: emodel.eulerian_autocorrelation(
                nsamples=EUL_SAMPLES, fields=["dens"]), walls, name)
            same_result(np, first, (et, eres), name)
            hold_close(np, et, [0.0, 0.5, 1.0], f"{name} times", rtol=TOL_PRT)
            if translating:
                ct, cres = fava_tpu_torch.FLASH(edir, device="cpu").eulerian_autocorrelation(
                    nsamples=EUL_SAMPLES, fields=["dens"])
                hold_close(np, eres["dens"], cres["dens"], f"{name} against the CPU", rtol=TOL_PRT)
                if not eres["dens"][-1] < 0.95:
                    fail(f"phase 24g: the translating field does not decorrelate: {eres['dens']}")
            else:
                hold_close(np, eres["dens"], np.ones(3), name, rtol=TOL_PRT)
            leaves = int(emodel.mesh.get_blocklist("LEAF").size)
            if translating:
                # The driver's host lookup: a (points x leaves) boolean matrix.
                from fava_tpu_torch.analysis.auto_correlations import _sample_grid_points

                points = _sample_grid_points(emodel.mesh, EUL_SAMPLES, np.random.default_rng(0))
                t0 = time.perf_counter()
                emodel.mesh.locate_points(points)
                walls["locate_points_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                emodel.mesh.sample_fields(points, ["dens"])
                walls["sample_fields_s"] = time.perf_counter() - t0
            del emodel
    launched = {k: v for k, v in ck.launch_counts().items() if v}
    if launched:
        fail(f"phase 24: the particle paths launched kernels: {launched}")
    walls["peak_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    walls["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 24 checks: lagrangian max |diff| {lag_err!r}, cross {cross_err!r}, partners equal "
        f"cKDTree's, pair counts exact over {pairs} binned pairs, Eulerian on {leaves} leaves")
    say(f"phase 24 particle timings: {json.dumps({'card': card, 'tracers': PRT_N, 'snapshots': PRT_SNAPSHOTS, 'file_bytes': nbytes, **walls})}")
    return walls


# ---------------------------------------------------------------------------
# Phase 25: the sharded paths (parallel/) in a one-rank NCCL world

VIRTUAL_RANKS = (2, 4, 8)
# The virtual ranks' summed shell sums against the single-device sums:
# float64 sums of the same float32 powers in another order, of scale. The
# sharded step against the single-device step takes compare_flagship's
# bounds: the spectra carry two float32 transform decompositions (rfft2 +
# fft along x, against rfftn), the profiles the same kernels on the same
# rows.
TOL_VIRTUAL = 1e-9
SHARDED_KERNELS = ("shell_bin_values_rfft_chunk", "row_moments", "centered_row_moments")


def hold_sums(what, got, ref, tol, phase=25):
    """max |diff| / scale of shell sums (scale: the largest |ref|)."""
    err = float((got - ref).abs().max() / ref.abs().max())
    say(f"phase {phase} {what}: max|diff|/scale {err!r} (bound {tol!r})")
    if not err <= tol:
        fail(f"{what} disagrees with its reference")
    return err


def virtual_ranks(torch, ck, spectra, fields, nbins):
    """The global rfftn cut into d y-slabs; each slab's powers and B6 at
    its offset (the rank-local binning of the sharded spectra), summed,
    against the single device's binning of the same float32 power volumes
    (K3 + K4); B6 on one transposed slab against its plain twin, and timed
    against its bound."""
    nx, ny, nz = (int(s) for s in fields[0].shape)
    ffts = spectra.kinetic_transforms(fields[0], fields[1:])
    _counts, whole = ck.shell_bin_sums_rfft(*spectra.rfft_power_volumes(ffts, (nx, ny, nz)),
                                            nbins, nz)
    def summed(d):
        cols = ny // d
        return sum(spectra.slab_shell_sums([f[:, r * cols : (r + 1) * cols] for f in ffts],
                                           (nx, ny, nz), r * cols, nbins) for r in range(d))

    runs = {f"{d} virtual ranks": (lambda d=d: summed(d), {"shell_bin_values_rfft_chunk": d})
            for d in VIRTUAL_RANKS}
    sums, _, _ = run_exact_counts(torch, ck, 25, runs, "sharded")
    errs = {d: hold_sums(f"{d} virtual ranks' summed shell sums vs the single device",
                         sums[f"{d} virtual ranks"], whole, TOL_VIRTUAL) for d in VIRTUAL_RANKS}
    lo, cols = ny // 4, ny // 4  # rank 1 of 4: a slab off the origin
    total, longi = spectra.rfft_power_volumes(
        [f[:, lo : lo + cols] for f in ffts], (nx, ny, nz),
        jy=torch.arange(lo, lo + cols, device=fields[0].device),
        ky=spectra._wavenumbers(ny, torch.float32, fields[0].device)[lo : lo + cols])
    t, lg = total.transpose(0, 1).contiguous(), longi.transpose(0, 1).contiguous()
    del ffts, total, longi
    got = ck.shell_bin_values_rfft_chunk(t, lg, nbins, ny, nz, lo)
    torch.cuda.synchronize()
    ref = ck._shell_bin_unfolded_plain(t.double(), lg.double(), nbins, nz, lo, ny)
    err = (got[:2] - ref).abs()
    ratio = float((err / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
    inside = inside_cells(ck, t, nbins, full_nz=nz, kx0=lo, full_nx=ny)
    row = kernel_row(torch, 25, f"B6 on the transposed slab {tuple(t.shape)} at kx0 {lo}",
                     float(err.max()), ratio, TOL_BIN,
                     lambda: ck.shell_bin_values_rfft_chunk(t, lg, nbins, ny, nz, lo),
                     lambda: ck._shell_bin_unfolded_plain(t, lg, nbins, nz, lo, ny),
                     (8 * inside + 16 * nbins, 8 * inside))
    return errs, row


def collectives_ms(torch, dist, fft, runtime, mesh, shape, nbins):
    """Device ms of the sharded step's collectives alone, at its shapes:
    three x <-> y exchanges of a (nx, ny, nz//2+1) complex64 transform
    (with their layout copies), the all_reduce of the (3, nbins) sums and
    the all_gather of the (22, nx) row statistics."""
    nx, ny, nz = shape
    dev = mesh.device_type
    w = torch.zeros((nx, ny, nz // 2 + 1), dtype=torch.complex64, device=dev)
    sums = torch.zeros((3, nbins), dtype=torch.float64, device=dev)
    rows = torch.zeros((22, nx), dtype=torch.float64, device=dev)

    def run():
        for _ in range(3):
            fft.transpose_xy(w, mesh)
        dist.all_reduce(sums, group=runtime.space_group(mesh))
        runtime.gather_slabs(rows, mesh, dim=1)

    ms = cuda_ms(torch, run, 5)
    del w
    return ms


def phase_sharded(torch, np, workdir: Path, card: str):
    """Phase 25 (after phase 23, on its window file): a one-rank NCCL
    world on cuda:0 (file:// store in the phase's temp dir) and the meshes
    (1,) "space" and (1, 1) "snap", "space". A one-rank space axis takes
    the single-device path, so the sharded functions are called directly:
    ``sharded_power_spectra``, the mesh branch of
    ``uniform_analysis_step``, ``sharded_series_analysis_step`` (a batch
    of 2) and the pencil transform, each with exact launches and held to
    the single-device step on the 512^3 example fields; virtual ranks
    d = 2, 4, 8 (the global rfftn cut into d y-slabs, each binned by B6
    at its offset, summed) against the single-device sums, and B6 on a
    transposed slab against its plain twin; ``FLASH(d)`` on the window
    file under the mesh (``load("uni")``, ``kinetic_energy_spectra``,
    ``flagship_analysis``) against the same calls without one; then the
    sharded and single-device steps and the collectives alone by CUDA
    events."""
    import torch.distributed as dist

    import fava_tpu_torch
    from fava_tpu_torch import flagship, parallel
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import spectra
    from fava_tpu_torch.parallel import fft, runtime

    t_phase = time.perf_counter()
    times = {"card": card}
    totals = {}
    with tempfile.TemporaryDirectory(prefix="fava_world_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=runtime.COLLECTIVE_TIMEOUT)
        try:
            m1 = parallel.make_device_mesh((1,), device="cuda")
            m2 = parallel.make_device_mesh((1, 1), (parallel.SNAP_AXIS, parallel.SPACE_AXIS),
                                           device="cuda")
            say(f"phase 25 one-rank NCCL world: backend {dist.get_backend()}, meshes {m1} and {m2}")
            fields = flagship.make_example_fields(N)
            batch = flagship.make_example_field_batch(2, N)
            nbins = N // 2 - 1
            runs = {
                "sharded_power_spectra": (
                    lambda: spectra.sharded_power_spectra(fields[0], fields[1:], m1, nbins),
                    {"shell_bin_values_rfft_chunk": 1}),
                "uniform_analysis_step(mesh)": (
                    lambda: flagship.uniform_analysis_step(*fields, mesh=m1),
                    dict.fromkeys(SHARDED_KERNELS, 1)),
                "sharded_series_analysis_step x2": (
                    lambda: flagship.sharded_series_analysis_step(*batch, mesh=m2),
                    dict.fromkeys(SHARDED_KERNELS, 2)),
            }
            out, times["walls_s"], totals = run_exact_counts(torch, ck, 25, runs, "sharded")
            counts, sums = spectra.rfft_shell_sums(fields[0], fields[1:], nbins)
            c1, s1 = out["sharded_power_spectra"]
            if not torch.equal(c1, counts):
                fail("sharded_power_spectra's counts differ from the single device's")
            hold_sums("sharded_power_spectra vs the single device", s1, sums, TOL_SPECTRA)
            floor = output_floors(fields)
            step = {k: v.cpu().numpy() for k, v in out["uniform_analysis_step(mesh)"].items()}
            check_outputs(np, step, (N, N, N), "single")
            single = {k: v.cpu().numpy() for k, v in flagship.uniform_analysis_step(*fields).items()}
            times["step_errors"] = compare_flagship(np, step, single, floor, "mesh step vs single", 25)
            series = {k: v.cpu().numpy() for k, v in out["sharded_series_analysis_step x2"].items()}
            check_outputs(np, series, (N, N, N), "series")
            for i in range(2):
                ref = {k: v.cpu().numpy() for k, v in
                       flagship.uniform_analysis_step(*(b[i] for b in batch)).items()}
                compare_flagship(np, {k: v[i] for k, v in series.items()}, ref, floor,
                                 f"pod step snapshot {i} vs single", 25)
            del batch, series, out

            x = fields[0]
            want = torch.fft.fftn(x)
            if not torch.equal(parallel.pfft3(x, m1), want):
                fail("pfft3 on a one-rank space axis is not torch.fft.fftn")
            pencil = torch.fft.fft(fft.transpose_xy(torch.fft.fftn(x, dim=(1, 2)), m1), dim=0)
            hold_sums("the pencil transform (fftn over y, z; exchange; fft over x) vs fftn",
                      pencil, want, TOL_SPECTRA)
            del want, pencil

            times["virtual_rank_errors"], times["b6_transposed_slab"] = virtual_ranks(
                torch, ck, spectra, fields, nbins)

            plain_uni = fava_tpu_torch.FLASH(workdir)
            plain_uni.load(file_type="uni", file_index=0)
            ke0, flag0 = plain_uni.kinetic_energy_spectra(), plain_uni.flagship_analysis()
            wfloor = output_floors([plain_uni.mesh.data(k) for k in NAMES])
            del plain_uni
            with parallel.use_mesh(m1):
                uni = fava_tpu_torch.FLASH(workdir)
                uni.load(file_type="uni", file_index=0)
                if uni.mesh._dmesh is not None or tuple(uni.mesh._slab("dens").shape) != (N, N, N):
                    fail("a one-rank space axis sharded the window volume")
                ke1 = uni.kinetic_energy_spectra()
                flag1, n = counted(torch, ck, "flagship_analysis() under the mesh",
                                   uni.flagship_analysis, FLAGSHIP_KERNELS, 25)
                add_counts(totals, n)
            del uni
            for key in ("total", "longitudinal", "transverse"):
                hold_sums(f"window KE spectra {key} under the mesh vs without",
                          torch.from_numpy(ke1[key]), torch.from_numpy(ke0[key]), TOL_BIN)
            compare_flagship(np, flag1, flag0, wfloor, "window flagship under the mesh vs without",
                             25, bound_of=lambda key: TOL_BIN)

            step_ms = cuda_ms(torch, lambda: flagship.uniform_analysis_step(*fields, mesh=m1), 5)
            single_ms = cuda_ms(torch, lambda: flagship.uniform_analysis_step(*fields), 5)
            coll_ms = collectives_ms(torch, dist, fft, runtime, m1, (N, N, N), nbins)
            times.update({"sharded_step_ms": step_ms, "single_step_ms": single_ms,
                          "collectives_ms": coll_ms, "collectives_share": coll_ms / step_ms})
            del fields
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 25 sharded-path timings: {json.dumps(times)}")
    return totals


# ---------------------------------------------------------------------------
# Phase 26: AMR over devices and the pod series in a one-rank NCCL world

POD_KERNELS = {"shell_bin_values_rfft_chunk": NSNAP, "row_moments": NSNAP,
               "centered_row_moments": NSNAP}


def events_ms(torch, fn):
    """(fn(), device ms of the one call by CUDA events)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def counted_exact(torch, ck, what, fn, expect, totals, warm=False):
    """fn() once with the counters reset before and read after, held to
    its exact launches (no other kernel), timed by CUDA events; with
    ``warm``, the time is that of a second call (not counted)."""
    ck.reset_launch_counts()
    out, ms = events_ms(torch, fn)
    launches = {k: v for k, v in ck.launch_counts().items() if v}
    if launches != expect:
        fail(f"{what} launched {launches}, expected {expect}")
    add_counts(totals, launches)
    if warm:
        ms = events_ms(torch, fn)[1]
    say(f"phase 26 {what}: launches {launches}, {ms!r} ms{' warm' if warm else ''}")
    return out, ms


def virtual_leaf_shares(torch, np, ck, profiles, runtime, mesh, pod, totals):
    """26a: K5/K6 on d virtual ranks' leaf shares, each passed through the
    world all_gather of the one-rank pod, joined, trimmed and split as
    ``_stack_stats`` does, equal bit for bit to the single launch."""
    data, geom = mesh._profile_fields(), mesh._profile_geometry(0)
    nleaf = int(geom.blocklist.size)
    kernels = ("block_row_moments", "block_centered_row_moments")
    single, ms = counted_exact(torch, ck, f"K5/K6 on the {nleaf} leaves",
                               lambda: profiles._stack_stats(data, geom),
                               dict.fromkeys(kernels, 1), totals, warm=True)
    times = {"single_ms": ms}

    sizes = tuple(t.shape[0] for t in single)

    def shares(d):
        parts = [torch.cat(profiles._share_stats(
            profiles._leaf_fields(data, geom, runtime.Placement(0, r, d)), geom)) for r in range(d)]
        joined = torch.cat([runtime.gather_flat(p, pod, dim=1) for p in parts], dim=1)
        return joined, torch.cat(profiles._split_joined(joined, sizes, geom))

    for d in VIRTUAL_RANKS:
        (joined, whole), times[f"{d}_ranks_ms"] = counted_exact(
            torch, ck, f"K5/K6 on {d} virtual leaf shares of {-(-nleaf // d)}", lambda: shares(d),
            dict.fromkeys(kernels, d), totals, warm=True)
        if not torch.equal(whole, torch.cat(single)) or joined[:, nleaf:].any():
            fail(f"K5/K6 on {d} leaf shares differ from the single launch")
        say(f"phase 26 K5/K6 on {d} virtual leaf shares: equal bit for bit to the single launch")
    return times


def virtual_slabs(torch, np, ck, regrid, mesh, hosts, subdomain, names, totals):
    """26b: ``regrid_fields_slab``, the step of ``regrid_fields_sharded``,
    on each virtual rank: its tables, its local stack copied from the host
    arrays that ``from_amr`` passes (``hosts``, ``_host_field_stack`` of
    a mesh whose fields are not loaded) as the card's field dtype, and K7
    on its slab; stacked, equal to the single regrid."""
    from fava_tpu_torch.utils import field_dtype

    plan = regrid.RegridPlan(
        block_bounds=mesh.block_bounds, node_type=np.asarray(mesh.node_type),
        refine_level=np.asarray(mesh.refine_level), ncells_vec=mesh.nCellsVec,
        nblks_vec=mesh.nBlksVec, ndim=3,
        subdomain_coords=None if subdomain is None else np.array(subdomain))
    data = {k: mesh._field_stack(k) for k in names}
    what = f"{plan.out_shape} ({len(names)} fields)"
    single, ms = counted_exact(torch, ck, f"K7 on {what}",
                               lambda: regrid.regrid_fields(plan, data, names),
                               {"regrid_fields": 1}, totals, warm=True)
    times = {"single_ms": ms}
    nb = int(mesh.nblocks)
    for d in VIRTUAL_RANKS:
        splan = regrid.ShardedRegridPlan(plan, d)
        say(f"phase 26 {what} over {d} virtual ranks: bmax {splan.bmax} of nB {nb}, blocks a rank "
            f"{list(splan.block_counts)}")

        def slabs(d=d, splan=splan):
            parts = [regrid.regrid_fields_slab(splan, r, hosts, names, "cuda", field_dtype("cuda"))
                     for r in range(d)]
            return {k: torch.cat([p[k] for p in parts]) for k in names}

        got, times[f"{d}_ranks_ms"] = counted_exact(
            torch, ck, f"K7 on {d} virtual slabs of {what} from host stacks", slabs,
            {"regrid_fields": d}, totals, warm=True)
        for k in names:
            if not torch.equal(got[k], single[k]):
                fail(f"the {d} stacked slabs of {k} differ from the single regrid")
        times[f"{d}_ranks_bmax"] = splan.bmax
        del got
        say(f"phase 26 K7 on {d} virtual slabs of {what}: stacked, equal to the single regrid")
    del single, data
    torch.cuda.empty_cache()
    return times


def pod_series(torch, np, ck, fava_tpu_torch, parallel, workdir: Path, pod, totals):
    """26c: flagship_series(batch=2) on the (1, 1) pod against the call
    without a mesh, row by row."""
    model = fava_tpu_torch.FLASH(workdir)
    if model.nfiles("uni") != NSNAP:
        fail(f"phase 26 expected phase 17's {NSNAP} uniform files, found {model.nfiles('uni')}")
    # One snapshot through each path first, so that neither timed call
    # pays the first call's plans and allocations.
    model.flagship_series(batch=1, file_indices=[0])
    with parallel.use_mesh(pod):
        model.flagship_series(batch=1, file_indices=[0])
    ref, ref_ms = counted_exact(torch, ck, "flagship_series(batch=2) without a mesh",
                                lambda: model.flagship_series(batch=2),
                                dict.fromkeys(FLAGSHIP_KERNELS, NSNAP), totals)
    with parallel.use_mesh(pod):
        got, pod_ms = counted_exact(torch, ck, "flagship_series(batch=2) on the (1, 1) pod",
                                    lambda: model.flagship_series(batch=2), POD_KERNELS, totals)
    if not np.array_equal(got["times"], ref["times"]) or not np.array_equal(
            got["spectra_counts"], ref["spectra_counts"]):
        fail("the pod series' times or shell counts differ from the series without a mesh")
    rms = float(np.abs(ref["favre_rms"]).max())
    floor = {"favre_mean": rms, "favre_rms": rms,
             "reynolds_stress": float(np.abs(ref["mean_dens"]).max()) * rms**2}
    errs = {}
    for j in range(NSNAP):
        errs[j] = compare_flagship(np, {k: v[j] for k, v in got.items() if k != "times"},
                                   {k: v[j] for k, v in ref.items() if k != "times"}, floor,
                                   f"pod series snapshot {j} vs without a mesh", 26)
    return {"series_ms": ref_ms, "pod_series_ms": pod_ms,
            "worst": max(max(e.values()) for e in errs.values())}


def pod_profile_series(torch, np, ck, fava_tpu_torch, parallel, ddir: Path, pod, totals):
    """26d: reynolds_series and favre_series on the 288-leaf plt series
    under the (1, 1) pod against the calls without a mesh."""
    eulerian_series(np, ddir, translating=True)
    model = fava_tpu_torch.FLASH(ddir)
    model.load(file_type="plt", file_index=0)
    vmax = max(float(model.mesh.data(k).abs().max()) for k in NAMES[1:])
    dmax = float(model.mesh.data("dens").abs().max())
    model.mesh = None
    kernels = dict.fromkeys(("block_row_moments", "block_centered_row_moments"), 3)
    errs = {}
    for name in ("reynolds_series", "favre_series"):
        fn = getattr(model, name)
        ref, _ = counted_exact(torch, ck, f"{name} without a mesh", lambda: fn(file_type="plt"),
                               kernels, totals)
        with parallel.use_mesh(pod):
            got, _ = counted_exact(torch, ck, f"{name} on the (1, 1) pod",
                                   lambda: fn(file_type="plt"), kernels, totals)
        errs[name] = compare_profiles(np, got, ref, vmax, dmax, f"{name} on the pod", 26)
    return errs


def phase_pod(torch, np, workdir: Path, card: str):
    """Phase 26 (after phase 25, on phase 6's plt file, phase 8's window and
    phase 17's four 512^3 files): a one-rank NCCL world on cuda:0 and the
    (1, 1) "snap", "space" mesh. A one-rank mesh takes the single-device
    paths, so the sharded pieces run on virtual ranks: (a) K5/K6 on d = 2,
    4, 8 virtual leaf shares of the plt file's 34,192 leaves, joined through
    the pod's world all_gather and ``_stack_stats``' trim, equal bit for bit
    to the single launch; (b) ``regrid_fields_sharded``'s step on each
    virtual rank (its tables, its local stack copied from the host arrays
    ``from_amr`` passes, K7 on its slab), for the 512^3 window and the
    2048x512x512 full domain, stacked and equal to the single regrid, with
    each rank's bmax against nB; (c)
    ``flagship_series(batch=2)`` on the pod against the call without a
    mesh (TOL_SPECTRA, TOL_PROFILES, counts exact); (d) ``reynolds_series``
    and ``favre_series`` on phase 24's 288-leaf plt series under the pod
    against the calls without one; (e) ``SnapshotPrefetcher`` with the
    ingest placement on the window file: the fields arrive whole. Every
    step's launches are exact; (a)-(c) are timed by CUDA events."""
    import torch.distributed as dist

    import fava_tpu_torch
    from fava_tpu_torch import parallel
    from fava_tpu_torch.io import ingest
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import profiles, regrid

    t_phase = time.perf_counter()
    times = {"card": card}
    totals = {}
    with tempfile.TemporaryDirectory(prefix="fava_pod_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=parallel.runtime.COLLECTIVE_TIMEOUT)
        try:
            pod = parallel.make_device_mesh((1, 1), (parallel.SNAP_AXIS, parallel.SPACE_AXIS),
                                            device="cuda")
            amr = fava_tpu_torch.FLASH(workdir)
            amr.load(file_type="plt")
            t0 = time.perf_counter()
            amr.mesh.load_data(list(NAMES))
            torch.cuda.synchronize()
            times["plt_read_s"] = time.perf_counter() - t0
            times["leaf_shares"] = virtual_leaf_shares(torch, np, ck, profiles, parallel.runtime,
                                                       amr.mesh, pod, totals)
            cold = fava_tpu_torch.FLASH(workdir)
            cold.load(file_type="plt")
            t0 = time.perf_counter()
            hosts = {k: cold.mesh._host_field_stack(k) for k in NAMES}
            times["host_stacks_read_s"] = time.perf_counter() - t0
            if not all(isinstance(h, np.ndarray) for h in hosts.values()):
                fail("_host_field_stack of a mesh without loaded fields is not a host array")
            times["regrid_window"] = virtual_slabs(torch, np, ck, regrid, amr.mesh, hosts,
                                                   AMR_WINDOW, list(NAMES), totals)
            times["regrid_full_domain"] = virtual_slabs(torch, np, ck, regrid, amr.mesh, hosts,
                                                        None, ["dens"], totals)
            del amr, cold, hosts
            torch.cuda.empty_cache()
            times["pod_series"] = pod_series(torch, np, ck, fava_tpu_torch, parallel, workdir, pod,
                                             totals)
            ddir = Path(tmp) / "plt288"
            ddir.mkdir()
            times["profile_series_errors"] = pod_profile_series(
                torch, np, ck, fava_tpu_torch, parallel, ddir, pod, totals)
            window = workdir / "rt_hdf5_uniform_0001"
            fn = parallel.ingest_sharding_fn(pod)
            (placed,) = ingest.SnapshotPrefetcher([window], list(NAMES), sharding=fn)
            (whole,) = ingest.SnapshotPrefetcher([window], list(NAMES))
            if any(p != parallel.Placement(0, 0, 1) for p in placed.placements.values()):
                fail(f"the ingest placement on a one-rank pod is {placed.placements}")
            if not all(torch.equal(placed.fields[k], whole.fields[k]) for k in NAMES):
                fail("the placed ingest of the window differs from the whole read")
            say(f"phase 26 ingest on the (1, 1) pod: {len(NAMES)} fields of the window arrive whole "
                f"{tuple(placed.fields['dens'].shape)}, equal to the read without a placement")
            del placed, whole
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 26 AMR-over-devices and pod timings: {json.dumps(times)}")
    return totals


# ---------------------------------------------------------------------------
# Phase 27: the rank-local analyses (A11d) in a one-rank NCCL world

# The one-rank mesh path and the virtual ranks against the single device:
# the profiles, the volume sums and the real-space summary and gradient
# sums are float64 sums of the same float32 values in another order
# (TOL_RANKLOCAL of scale; the profiles floored as compare_profiles
# floors them, the gradient entries by their natural scale); the scalar
# spectrum and the summary's spectral entries carry another float32
# transform decomposition (the pencil: rfft2, exchange, fft along x,
# against rfftn; TOL_SPECTRA of scale); the structure functions and the
# increment PDFs read the same float32 cells and are equal bit for bit;
# the box counts are equal. The PDFs of A11e: the MIN/MAX-edged ones
# (pdf1d, pdf2d, binned_statistic) bin the same float32 samples against
# the same edges (an exact join), so their counts are equal, their
# weighted sums within TOL_WSUM a bin (float64 atomics in another order)
# and the binned means and standard deviations within TOL_RANKLOCAL of
# their largest; the density and Q-R PDFs' edges come from float64 means
# (TOL_RANKLOCAL), so on virtual ranks a sample within an edge's last
# place may change bin: their cells that differ are printed, the moved
# samples held to TOL_SHIFT (density) and MAX_QR_MOVED of the cells
# (Q-R), and on the (1,) mesh, which sums in the single device's order,
# the counts are equal. The velocity spectra: TOL_SPECTRA of scale
# (their own largest shell; the decomposed spectra the total's, which
# bounds a compressive part of rounding alone; helicity its Cauchy-
# Schwarz bound, signed_scales), transfer and flux TOL_TRANSFER of the
# sum of their shells' bounds (signed_scales of the undealiased
# products, which bound the dealiased ones' factors too).
TOL_RANKLOCAL = 1e-9
RANKLOCAL_K12 = {"row_moments": 1, "centered_row_moments": 1}
RANKLOCAL_B6 = "shell_bin_values_rfft_chunk_1ch"
RANKLOCAL_SLAB = (128, 512, 257)  # (c): rank 1 of 4's transposed y-slab of the 512^3 half-spectrum


def ranklocal_runs(ops, inputs, mesh):
    """{name: (fn, exact launches)} of the slice's analyses through their
    ops entries, with ``mesh`` or on the single device (mesh None)."""
    profiles, volume, spectra, fractal, structure, velocity, gradients = ops
    data, geoms, cv, cvb, blocklist, mask, flam, dens, vels, bounds, lengths = inputs
    def b6(n):
        """n binned densities: the one-channel B6 on the mesh, K3 + the
        one-channel B4 on the single device (the window's even x and y)."""
        return {RANKLOCAL_B6: n} if mesh is not None else {"fold_quadrants_pair": n,
                                                           "shell_bin_values_folded_1ch": n}

    scalar = b6(1)
    return {
        "reynolds_stress x": (lambda: profiles.reynolds_stress(data, geoms[0], mesh=mesh)[1:],
                              RANKLOCAL_K12),
        "favre_profiles x": (lambda: profiles.favre_profiles(data, geoms[0], mesh=mesh), RANKLOCAL_K12),
        "reynolds_stress y": (lambda: profiles.reynolds_stress(data, geoms[1], mesh=mesh)[1:], {}),
        "slice_integral z": (lambda: profiles.slice_integral(data["dens"], geoms[2], mesh=mesh)[1], {}),
        "volume_integration": (lambda: volume.volume_integration(data["dens"], cv, blocklist,
                                                                 mesh=mesh), {}),
        "mass_sum": (lambda: volume.mass_sum(data["dens"], cvb, {"dense": mask}, mesh=mesh), {}),
        "scalar spectrum": (lambda: spectra.scalar_spectrum(dens, mesh=mesh), scalar),
        "fractal dimension": (lambda: fractal.fractal_dimension(flam, [0.5, None], mesh=mesh), {}),
        "structure functions": (lambda: structure.structure_functions(
            vels, domain_bounds=bounds, mesh=mesh), {}),
        "velocity increment pdfs": (lambda: structure.velocity_increment_pdfs(
            vels, domain_bounds=bounds, mesh=mesh), {}),
        "turbulence summary": (lambda: velocity.turbulence_summary(
            *vels, dens=dens, lengths=lengths, mesh=mesh), {}),
        "gradient statistics": (lambda: gradients.velocity_gradient_statistics(
            *vels, lengths=lengths, mesh=mesh), {}),
        "gradient statistics interior": (lambda: gradients.velocity_gradient_statistics(
            *vels, lengths=lengths, boundary="interior", mesh=mesh), {}),
        # The slice of A11e: the PDFs, the Q-R PDF (B8) and the velocity
        # spectra (one B6 a binned density).
        "pdf1d": (lambda: volume.pdf1d(vels[0], mesh=mesh), {}),
        "pdf1d mass": (lambda: volume.pdf1d(dens, weights=dens, mesh=mesh), {}),
        "pdf2d": (lambda: volume.pdf2d(dens, vels[0], mesh=mesh), {"pdf2d_counts": 1}),
        "pdf2d mass": (lambda: volume.pdf2d(dens, vels[0], weights=dens, mesh=mesh),
                       {"pdf2d_weighted": 1}),
        "binned statistic": (lambda: volume.binned_statistic(dens, vels[0], mesh=mesh), {}),
        "density pdf": (lambda: volume.density_pdf(dens, mesh=mesh), {}),
        "gradient invariant pdfs": (lambda: gradients.gradient_invariant_pdfs(
            *vels, lengths=lengths, mesh=mesh), {"pdf2d_counts": 1}),
        "gradient invariant pdfs interior": (lambda: gradients.gradient_invariant_pdfs(
            *vels, lengths=lengths, boundary="interior", mesh=mesh), {"pdf2d_counts": 1}),
        "enstrophy spectra": (lambda: velocity.enstrophy_spectrum(*vels, lengths=lengths,
                                                                  mesh=mesh), b6(1)),
        "helicity spectra": (lambda: velocity.helicity_spectrum(*vels, lengths=lengths, mesh=mesh),
                             b6(1)),
        "decomposed spectra": (lambda: velocity.decomposed_ke_spectra(*vels, lengths=lengths,
                                                                      mesh=mesh), b6(3)),
        "decomposed spectra weighted": (lambda: velocity.decomposed_ke_spectra(
            *vels, dens=dens, lengths=lengths, mesh=mesh), b6(3)),
        "anisotropic spectra x": (lambda: velocity.anisotropic_ke_spectra(*vels, axis=0, mesh=mesh),
                                  {}),
        "anisotropic spectra y": (lambda: velocity.anisotropic_ke_spectra(*vels, axis=1, mesh=mesh),
                                  {}),
        "transfer spectra": (lambda: velocity.transfer_spectrum(*vels, lengths=lengths, mesh=mesh),
                             b6(1)),
        "transfer spectra dealiased": (lambda: velocity.transfer_spectrum(
            *vels, lengths=lengths, dealias=True, mesh=mesh), b6(1)),
    }


def virtual_ranklocal_runs(ops, runtime, inputs, d):
    """The rank-local bodies on d virtual ranks' x-slabs (views of the
    whole volumes), joined by the code that the collectives feed
    (``runtime.SpaceRanks(d=d)``); the spectral bodies take their y-slab
    of the whole transform. The same names as ``ranklocal_runs``."""
    profiles, volume, spectra, fractal, structure, velocity, gradients = ops
    data, geoms, cv, cvb, blocklist, mask, flam, dens, vels, bounds, lengths = inputs
    ranks = runtime.SpaceRanks(d=d)
    n = int(dens.shape[0]) // d

    def cut(t, dim=0):
        return [t.narrow(dim, r * n, n) for r in range(d)]

    stacks = [{k: v.narrow(1, r * n, n) for k, v in data.items()} for r in range(d)]
    vel_slabs = [list(v) for v in zip(*(cut(v) for v in vels))]
    k12 = {k: d for k in RANKLOCAL_K12}
    return {
        "reynolds_stress x": (lambda: profiles.reynolds_stress_ranked(stacks, geoms[0], ranks)[1:],
                              k12),
        "favre_profiles x": (lambda: profiles.favre_profiles_ranked(stacks, geoms[0], ranks), k12),
        "reynolds_stress y": (lambda: profiles.reynolds_stress_ranked(stacks, geoms[1], ranks)[1:],
                              {}),
        "slice_integral z": (lambda: profiles.slice_integral_ranked(
            cut(data["dens"], 1), geoms[2], ranks)[1], {}),
        "scalar spectrum": (lambda: spectra.scalar_spectrum_from_slabs(
            ranks.pencil_rfft(cut(dens)), tuple(dens.shape), ranks), {RANKLOCAL_B6: d}),
        "fractal dimension": (lambda: fractal.fractal_dimension_ranked(cut(flam), ranks,
                                                                       [0.5, None]), {}),
        "structure functions": (lambda: structure.structure_functions_ranked(
            vel_slabs, ranks, domain_bounds=bounds), {}),
        "velocity increment pdfs": (lambda: structure.velocity_increment_pdfs_ranked(
            vel_slabs, ranks, domain_bounds=bounds), {}),
        "turbulence summary": (lambda: dict(zip(
            velocity.summary_names(True, False),
            velocity.turbulence_summary_ranked(vel_slabs, ranks, cut(dens), lengths=lengths)
            .cpu().numpy().tolist())), {}),
        "gradient statistics": (lambda: gradients.assemble_gradient_stats(
            gradients.gradient_stats_ranked(vel_slabs, ranks, lengths).cpu().numpy(), 3), {}),
        "gradient statistics interior": (lambda: gradients.assemble_gradient_stats(
            gradients.gradient_stats_ranked(vel_slabs, ranks, lengths, "interior").cpu().numpy(),
            3), {}),
        "pdf1d": (lambda: volume.pdf1d_ranked(cut(vels[0]), ranks), {}),
        "pdf1d mass": (lambda: volume.pdf1d_ranked(cut(dens), ranks, weights=cut(dens)), {}),
        "pdf2d": (lambda: volume.pdf2d_ranked(cut(dens), cut(vels[0]), ranks), {"pdf2d_counts": d}),
        "pdf2d mass": (lambda: volume.pdf2d_ranked(cut(dens), cut(vels[0]), ranks,
                                                   weights=cut(dens)), {"pdf2d_weighted": d}),
        "binned statistic": (lambda: volume.binned_statistic_ranked(cut(dens), cut(vels[0]), ranks),
                             {}),
        "density pdf": (lambda: volume.density_pdf_ranked(cut(dens), ranks), {}),
        "gradient invariant pdfs": (lambda: gradients.gradient_invariant_pdfs_ranked(
            vel_slabs, ranks, lengths), {"pdf2d_counts": d}),
        "gradient invariant pdfs interior": (lambda: gradients.gradient_invariant_pdfs_ranked(
            vel_slabs, ranks, lengths, boundary="interior"), {"pdf2d_counts": d}),
        "enstrophy spectra": (lambda: velocity.velocity_spectrum_ranked(
            vel_slabs, ranks, lengths, "enstrophy"), {RANKLOCAL_B6: d}),
        "helicity spectra": (lambda: velocity.velocity_spectrum_ranked(
            vel_slabs, ranks, lengths, "helicity"), {RANKLOCAL_B6: d}),
        "decomposed spectra": (lambda: velocity.decomposed_ke_spectra_ranked(
            vel_slabs, ranks, None, lengths), {RANKLOCAL_B6: 3 * d}),
        "decomposed spectra weighted": (lambda: velocity.decomposed_ke_spectra_ranked(
            vel_slabs, ranks, cut(dens), lengths), {RANKLOCAL_B6: 3 * d}),
        "anisotropic spectra x": (lambda: velocity.anisotropic_ke_spectra_ranked(
            vel_slabs, ranks, 0), {}),
        "anisotropic spectra y": (lambda: velocity.anisotropic_ke_spectra_ranked(
            vel_slabs, ranks, 1), {}),
        "transfer spectra": (lambda: velocity.transfer_spectrum_ranked(
            vel_slabs, ranks, lengths, False), {RANKLOCAL_B6: d}),
        "transfer spectra dealiased": (lambda: velocity.transfer_spectrum_ranked(
            vel_slabs, ranks, lengths, True), {RANKLOCAL_B6: d}),
    }


def same_nested(np, a, b):
    """Nested dicts of arrays and floats equal bit for bit (NaN where NaN)."""
    if isinstance(b, dict):
        return sorted(a) == sorted(b) and all(same_nested(np, a[k], b[k]) for k in b)
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def spectra_error(np, name, g, r, scales):
    """max |diff| / (scale * bound) of one velocity spectrum of the slice
    against the single device's (the phase's comment): NaN in the same
    shells, the wavenumbers equal."""
    worst = 0.0
    for key, rv in r.items():
        gv = np.asarray(g[key])
        if key.startswith("k"):
            if not np.array_equal(gv, rv):
                fail(f"phase 27 {name}/{key}: other wavenumbers than the single device's")
            continue
        if not np.array_equal(np.isnan(gv), np.isnan(rv)):
            fail(f"phase 27 {name}/{key}: NaN in other shells than the single device's")
        ok = ~np.isnan(rv)
        if name.startswith("transfer"):
            scale, tol = scales["transfer"], TOL_TRANSFER
        elif name.startswith("helicity"):
            scale, tol = scales["helicity"], TOL_SPECTRA
        elif name.startswith("decomposed"):
            scale, tol = np.nanmax(np.abs(r["total"])), TOL_SPECTRA
        elif name.startswith("anisotropic"):
            scale, tol = np.abs(r[key.split("_")[0] + "_total"]).max(), TOL_SPECTRA
        else:
            scale, tol = np.abs(rv[ok]).max(), TOL_SPECTRA
        worst = max(worst, float(np.abs(gv[ok] - rv[ok]).max() / scale / tol))
    return worst


def edged_pdf_error(np, name, g, r, ncells, same_edges, differ):
    """The density PDF and the Q-R PDF against the single device's: the
    moments, Q_w and the edges (normalised, or of the float64 mean and
    sigma) within TOL_RANKLOCAL; the counts equal on the mesh
    (``same_edges``), else the cells that differ recorded in ``differ``
    and the samples moved held to TOL_SHIFT (density) or MAX_QR_MOVED of
    the cells (Q-R): an edge from another float64 sum order moves only
    the samples within its last place."""
    errs = []
    if name == "density pdf":
        sigma = r["sigma_s"]
        for key in ("rho_mean", "mean_s", "sigma_s", "skewness", "excess_kurtosis"):
            errs.append(abs(g[key] - r[key]) / max(abs(r[key]), sigma, 1e-300))
        errs.append(abs(g["lognormal_residual"] - r["lognormal_residual"]) / sigma**2)
        span = r["edges"][-1] - r["edges"][0]
        errs.append(float(np.abs(g["edges"] - r["edges"]).max() / span))
    else:
        errs.append(abs(g["q_w"] - r["q_w"]) / r["q_w"])
        if not (np.array_equal(g["q_edges"], r["q_edges"])
                and np.array_equal(g["r_edges"], r["r_edges"])):
            fail(f"phase 27 {name}: other normalised edges than the single device's")
    cells = int((np.asarray(g["counts"]) != np.asarray(r["counts"])).sum())
    moved = float(np.abs(np.asarray(g["counts"]) - np.asarray(r["counts"])).sum()) / 2
    differ[name] = cells
    if same_edges and cells:
        fail(f"phase 27 {name}: {cells} cells differ from the single device's on the mesh")
    worst = max(errs) / TOL_RANKLOCAL
    if name == "density pdf":
        return max(worst, moved / TOL_SHIFT)
    return max(worst, moved / ncells / MAX_QR_MOVED)


def hold_ranklocal(np, got, ref, vmax, dmax, what, scales, ncells, same_edges):
    """Hold each analysis of the slice to the single device's result
    (TOL_RANKLOCAL, TOL_SPECTRA, TOL_TRANSFER, TOL_WSUM, equality: the
    phase's comment). ``scales`` are the signed spectra's
    (``signed_scales``); ``same_edges`` says that the density and Q-R
    PDFs' edges come from the same sums (the mesh), so their counts must
    be equal."""
    worst, differ = {}, {}
    for name, r in ref.items():
        g = got[name]
        if name in ("pdf1d", "pdf2d", "binned statistic", "pdf1d mass", "pdf2d mass"):
            edges = [k for k in r if k.endswith("edges")]
            if not all(np.array_equal(g[k], r[k]) for k in edges):
                fail(f"{what} {name}: other edges than the single device's (an exact MIN/MAX join)")
            if name.endswith("mass"):
                err = np.abs(g["counts"] - r["counts"]) / (TOL_WSUM * np.abs(r["counts"])).clip(1e-300)
                worst[name] = float(err.max())
            elif not np.array_equal(g["counts"], r["counts"]):
                fail(f"{what} {name}: counts differ from the single device's in "
                     f"{int((g['counts'] != r['counts']).sum())} bins")
            elif name == "binned statistic":
                worst[name] = max(float(np.nanmax(np.abs(g[k] - r[k])) / np.nanmax(np.abs(r[k])))
                                  for k in ("mean", "std")) / TOL_RANKLOCAL
            else:
                worst[name] = 0.0 if np.array_equal(g["pdf"], r["pdf"]) else float("inf")
        elif name == "density pdf" or name.startswith("gradient invariant pdfs"):
            worst[name] = edged_pdf_error(np, name, g, r, ncells, same_edges, differ)
        elif "spectra" in name:
            worst[name] = spectra_error(np, name, g, r, scales)
        elif name.startswith(("reynolds", "favre", "slice")):
            worst[name] = compare_profiles(np, g, r, vmax, dmax, f"{what} {name}", 27) / TOL_PROFILES
        elif name in ("volume_integration", "mass_sum"):
            pairs = [(g, r)] if name == "volume_integration" else [(g[k], r[k]) for k in r]
            worst[name] = max(abs(a - b) / abs(b) for a, b in pairs) / TOL_RANKLOCAL
        elif name == "scalar spectrum":
            gv, rv = g["power"], r["power"]
            if not np.array_equal(np.isnan(gv), np.isnan(rv)) or not np.array_equal(g["k"], r["k"]):
                fail(f"{what} {name}: other shells than the single device's")
            ok = ~np.isnan(rv)
            worst[name] = float(np.abs(gv[ok] - rv[ok]).max() / np.abs(rv[ok]).max()) / TOL_SPECTRA
        elif name == "turbulence summary":
            if list(g) != list(r):
                fail(f"{what} summary entries {list(g)} vs {list(r)}")
            worst[name] = max(abs(g[k] - v) / max(abs(v), 1e-300)
                              / (TOL_RANKLOCAL if k in SUMMARY_REAL_SPACE else TOL_SPECTRA)
                              for k, v in r.items())
        elif name.startswith("gradient statistics"):
            worst[name] = max(float(np.max(np.abs(np.asarray(g[k]) - np.asarray(r[k]))
                                           / np.maximum(scale, 1e-300)))
                              for k, scale in gradient_scales(np, r).items()) / TOL_RANKLOCAL
        else:  # the fractal dimension, structure functions, increment PDFs
            worst[name] = 0.0 if same_nested(np, g, r) else float("inf")
    top = max(worst, key=worst.get)
    say(f"phase 27 {what} vs the single device: worst error/bound {worst[top]!r} ({top}); "
        f"{json.dumps(worst)}; cells that differ from the single device's counts: "
        f"{json.dumps(differ)}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with the single device (error/bound): {bad}")
    return worst


def ranklocal_b6_row(torch, ck, dens):
    """(c): the one-channel B6 on a transposed (128, 512, 257) y-slab of
    the dens power at kx0 = 128 against its plain twin, timed against its
    bound (CUDA events)."""
    nx, ny, nz = (int(s) for s in dens.shape)
    nbins = max(nx, ny, nz) // 2 - 1
    cols, lo = RANKLOCAL_SLAB[0], RANKLOCAL_SLAB[0]
    f = torch.fft.rfftn(dens, norm="forward")[:, lo : lo + cols]
    p = (f.real.square() + f.imag.square()).transpose(0, 1).contiguous()
    del f
    if tuple(p.shape) != RANKLOCAL_SLAB:
        fail(f"phase 27 B6 slab {tuple(p.shape)}, expected {RANKLOCAL_SLAB}")
    got = ck.shell_bin_values_rfft_chunk(p, None, nbins, ny, nz, lo)
    torch.cuda.synchronize()
    ref = ck._shell_bin_unfolded_plain(p.double(), None, nbins, nz, lo, ny)
    if got.shape != (1, nbins):
        fail(f"the one-channel B6 gave {tuple(got.shape)}")
    err = (got - ref).abs()
    ratio = float((err / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
    inside = inside_cells(ck, p, nbins, full_nz=nz, kx0=lo, full_nx=ny)
    return kernel_row(torch, 27, f"one-channel B6 on the transposed slab {RANKLOCAL_SLAB} at kx0 {lo}",
                      float(err.max()), ratio, TOL_BIN,
                      lambda: ck.shell_bin_values_rfft_chunk(p, None, nbins, ny, nz, lo),
                      lambda: ck._shell_bin_unfolded_plain(p, None, nbins, nz, lo, ny),
                      (4 * inside + 8 * nbins, 4 * inside))


def phase_ranklocal(torch, np, workdir: Path, card: str):
    """Phase 27 (after phase 26, on phase 8's 512^3 window and phase 19's
    flam window): a one-rank NCCL world on cuda:0 and the (1,) "space"
    mesh. (a) Each analysis of the slice through its ops entry with
    ``mesh=`` the (1,) mesh (the rank-local path; the placement rule
    shards nothing on one rank) and on the single device, each with exact
    launches (the mesh's: K1 1 and K2 1 for the profiles along x, the
    one-channel B6 1 for the scalar spectrum), held to each other, with
    warm walls. (b) The rank-local bodies on d = 2, 4, 8 virtual ranks,
    joined by ``SpaceRanks(d=d)``: launches exactly d, box counts equal,
    the structure functions and increment PDFs equal bit for bit, sums
    within the stated bounds of the single device. (c) The one-channel B6
    on a transposed (128, 512, 257) slab at kx0 = 128 against its plain
    twin and its bound. (a) and (b) include the slice of A11e (the PDFs,
    the Q-R PDF, the velocity spectra: B8 and the one-channel B6 once a
    rank, or 3 times for the decomposed spectra)."""
    import torch.distributed as dist

    import fava_tpu_torch
    from fava_tpu_torch import parallel
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import fractal, gradients, profiles, spectra, structure, velocity, volume

    t_phase = time.perf_counter()
    times = {"card": card}
    totals = {}
    ops = (profiles, volume, spectra, fractal, structure, velocity, gradients)
    with tempfile.TemporaryDirectory(prefix="fava_ranklocal_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=parallel.runtime.COLLECTIVE_TIMEOUT)
        try:
            m1 = parallel.make_device_mesh((1,), device="cuda")
            uni = fava_tpu_torch.FLASH(workdir)
            uni.load(file_type="uni", file_index=0)
            mesh = uni.mesh
            flm = fava_tpu_torch.FLASH(workdir / "flam")
            flm.load(file_type="uni", fields=["flam"])
            dens = mesh._volume("dens")
            vels = [mesh._volume(f"vel{a}") for a in "xyz"]
            flam = flm.mesh._volume("flam")
            mask = (dens > dens.median()).cpu().numpy()[None]
            cv = mesh.get_cell_volumes()
            inputs = (mesh._profile_fields(), [mesh._profile_geometry(a) for a in range(3)],
                      cv, np.asarray(cv).reshape(-1, 1, 1, 1), mesh.get_blocklist("LEAF"), mask,
                      flam, dens, vels, mesh.domain_bounds, mesh._domain_lengths())
            vmax = max(float(v.abs().max()) for v in vels)
            dmax = float(dens.abs().max())
            sc = signed_scales(torch, ck, velocity, vels, mesh._domain_lengths())
            scales = {"helicity": sc["helicity spectra"], "transfer": sc["transfer spectra"]}
            times["signed_scales"] = scales
            ncells = dens.numel()
            single, times["single_walls_s"], counts = run_exact_counts(
                torch, ck, 27, ranklocal_runs(ops, inputs, None), "single device")
            add_counts(totals, counts)
            meshed, times["mesh_walls_s"], counts = run_exact_counts(
                torch, ck, 27, ranklocal_runs(ops, inputs, m1), "(1,) mesh")
            add_counts(totals, counts)
            times["mesh_errors"] = hold_ranklocal(np, meshed, single, vmax, dmax, "(1,) mesh",
                                                  scales, ncells, True)
            times["mesh_over_single"] = {k: times["mesh_walls_s"][k] / times["single_walls_s"][k]
                                         for k in single}
            del meshed
            flength = int(np.log2(min(flam.shape))) + 1
            for d in VIRTUAL_RANKS:
                got, times[f"{d}_ranks_walls_s"], counts = run_exact_counts(
                    torch, ck, 27, virtual_ranklocal_runs(ops, parallel.runtime, inputs, d),
                    f"{d} virtual ranks")
                add_counts(totals, counts)
                ref = {k: v for k, v in single.items() if k in got}
                times[f"{d}_ranks_errors"] = hold_ranklocal(np, got, ref, vmax, dmax,
                                                            f"{d} virtual ranks", scales, ncells,
                                                            False)
                ranks = parallel.runtime.SpaceRanks(d=d)
                n = N // d
                slabs = [flam.narrow(0, r * n, n) for r in range(d)]
                for c in (0.5, flam.double().mean().float()):
                    masks = [fractal.edge_detect(s, c, h, r * n, N)
                             for s, h, r in zip(slabs, ranks.halos(slabs), ranks.ranks)]
                    boxes = fractal.box_counts_ranked(masks, ranks, tuple(flam.shape), flength)
                    whole = fractal.box_counts(fractal.edge_detect(flam, c), flength)
                    if not np.array_equal(boxes, whole):
                        fail(f"box counts on {d} virtual ranks {boxes.tolist()} differ from the "
                             f"single device's {whole.tolist()}")
                say(f"phase 27 {d} virtual ranks: box counts equal to the single device's")
                del got
            row = ranklocal_b6_row(torch, ck, dens)
            del uni, flm, mesh, dens, vels, flam, inputs, single
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 27 rank-local timings: {json.dumps(times)}")
    if times["phase_s"] > 60:
        fail(f"phase 27 took {times['phase_s']:.1f} s, over its 60 s")
    return totals, row


# ---------------------------------------------------------------------------
# Phase 28: the rank-local spectral analyses (A11f.1) in a one-rank NCCL world

# The (1,) mesh and the virtual ranks against the single device: the
# pencil transform (rfft2, exchange, fft along x) against rfftn, so the
# fields, lines and shell curve carry another float32 transform
# decomposition: the lines and shell curve by hold_lines (TOL_SPECTRA);
# the Helmholtz parts TOL_SPECTRA of the largest |v| (a part may vanish);
# vorticity and dilatation, whose spectral derivative raises the
# transforms' float32 rounding (~2^-24 |v| at every wavenumber) by up to
# |k|, TOL_IDENTITY of max |v| * sum_i (2 pi / L_i) (n_i / 2), the bound
# of helmholtz_identities in physical wavenumbers; the flux's statistics
# TOL_FLUX of their term scales (flux_term_scales). SPECTRAL_CUTOFFS are
# the pipeline's; the pressure run takes the sharp kernel at
# SPECTRAL_PRESSURE_CUTOFFS.
SPECTRAL_CUTOFFS = (4.0, 8.0, 16.0)
SPECTRAL_PRESSURE_CUTOFFS = (8.0, 32.0)
SPECTRAL_GAMMA = 5.0 / 3.0
SPECTRAL_SLAB = (128, 512, 257)  # (c): rank 1 of 4's x-slab of the 512^3 correlation half-volume
SPECTRAL_FIELDS = ("helmholtz decomposition", "vorticity", "dilatation")


def spectral_runs(ops, inputs, mesh, host):
    """{name: (fn, exact launches)} of the six analyses through their ops
    entries, with ``mesh`` or on the single device (mesh None); the field
    analyses' results on the host (``SpaceRanks.host_volume``, as the
    mesh's methods return them) when ``host``, else on the card."""
    cg, tp, velocity, runtime = ops
    dens, pres, vels, lengths = inputs
    ranks = runtime.SpaceRanks(mesh)

    def fields(out):
        if isinstance(out, dict):
            return {k: fields(v) for k, v in out.items()}
        if isinstance(out, tuple):
            return {f"omega_{a}": fields(v) for a, v in zip("xyz", out)}
        return ranks.host_volume([out]) if host else out

    two_point = ({RANKLOCAL_B6: 1} if mesh is not None
                 else {"fold_quadrants_pair": 1, "shell_bin_values_folded_1ch": 1})
    return {
        "filtered ke flux": (lambda: cg.filtered_ke_flux(
            *vels, dens=dens, cutoffs=SPECTRAL_CUTOFFS, lengths=lengths, mesh=mesh), {}),
        "filtered ke flux pressure sharp": (lambda: cg.filtered_ke_flux(
            *vels, dens=dens, pres=pres, cutoffs=SPECTRAL_PRESSURE_CUTOFFS, kernel="sharp",
            lengths=lengths, mesh=mesh), {}),
        "two point correlation": (lambda: tp.two_point_correlation(dens, lengths=lengths,
                                                                   mesh=mesh), two_point),
        "velocity correlations": (lambda: tp.velocity_correlations(*vels, lengths=lengths,
                                                                   mesh=mesh), {}),
        "helmholtz decomposition": (lambda: fields(velocity.helmholtz_decompose(
            *vels, lengths=lengths, mesh=mesh)), {}),
        "vorticity": (lambda: fields(velocity.vorticity(*vels, lengths=lengths, mesh=mesh)), {}),
        "dilatation": (lambda: fields(velocity.dilatation(*vels, lengths=lengths, mesh=mesh)), {}),
    }


def virtual_spectral_runs(torch, ops, inputs, d):
    """The ranked bodies on d virtual ranks' x-slabs (views of the whole
    volumes), joined by ``runtime.SpaceRanks(d=d)``; the fields joined
    on the card. The same names as ``spectral_runs``."""
    cg, tp, velocity, runtime = ops
    dens, pres, vels, lengths = inputs
    ranks = runtime.SpaceRanks(d=d)
    n = int(dens.shape[0]) // d

    def cut(t):
        return [t.narrow(0, r * n, n) for r in range(d)]

    def joined(per_slab):
        first = per_slab[0]
        if isinstance(first, dict):
            return {k: joined([s[k] for s in per_slab]) for k in first}
        if isinstance(first, tuple):
            return {f"omega_{a}": joined([s[i] for s in per_slab]) for i, a in enumerate("xyz")}
        return torch.cat(per_slab)

    vel_slabs = [list(v) for v in zip(*(cut(v) for v in vels))]
    return {
        "filtered ke flux": (lambda: cg.filtered_ke_flux_ranked(
            vel_slabs, ranks, cut(dens), None, SPECTRAL_CUTOFFS, "gaussian", lengths), {}),
        "filtered ke flux pressure sharp": (lambda: cg.filtered_ke_flux_ranked(
            vel_slabs, ranks, cut(dens), cut(pres), SPECTRAL_PRESSURE_CUTOFFS, "sharp", lengths),
            {}),
        "two point correlation": (lambda: tp.two_point_correlation_ranked(cut(dens), ranks,
                                                                          lengths),
                                  {RANKLOCAL_B6: d}),
        "velocity correlations": (lambda: tp.velocity_correlations_ranked(vel_slabs, ranks,
                                                                          lengths), {}),
        "helmholtz decomposition": (lambda: joined(velocity.helmholtz_decompose_ranked(
            vel_slabs, ranks, lengths)), {}),
        "vorticity": (lambda: joined(velocity.vorticity_ranked(vel_slabs, ranks, lengths)), {}),
        "dilatation": (lambda: joined(velocity.dilatation_ranked(vel_slabs, ranks, lengths)), {}),
    }


def field_leaves(out):
    """The arrays of a field analysis's nested dict, by their key path."""
    if isinstance(out, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in out.items()
                for p, v in field_leaves(sub).items()}
    return {"": out}


def field_error(torch, got, ref):
    """max |diff| of one field (host numpy arrays or card tensors, in
    their float32)."""
    return float((torch.as_tensor(got) - torch.as_tensor(ref)).abs().max())


def hold_spectral(torch, np, got, ref, scales, field_bounds, what):
    """Each analysis of the slice against the single device's result (the
    phase's comment): the flux TOL_FLUX of its term scales, the lines and
    shell curve by ``hold_lines``, each field within its ``field_bounds``
    entry."""
    worst = {}
    for name, r in ref.items():
        g = got[name]
        if name.startswith("filtered ke flux"):
            worst[name] = hold_flux(np, g, r, scales[name], TOL_FLUX, f"{what} {name}", 28)
        elif name in SPECTRAL_FIELDS:
            gl, rl = field_leaves(g), field_leaves(r)
            if sorted(gl) != sorted(rl):
                fail(f"{what} {name}: fields {sorted(gl)}, expected {sorted(rl)}")
            errs = {k: field_error(torch, gl[k], rl[k]) / field_bounds[name] for k in rl}
            say(f"phase 28 {what} {name} vs the single device, error/bound per field: "
                f"{json.dumps(errs)}")
            worst[name] = max(errs.values())
        else:
            worst[name] = hold_lines(np, g, r, TOL_SPECTRA, f"{what} {name}", 28)["worst"]
    top = max(worst, key=worst.get)
    say(f"phase 28 {what} vs the single device: worst error/bound {worst[top]!r} ({top}); "
        f"{json.dumps(worst)}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with the single device (error/bound): {bad}")
    return worst


def spectral_b6_row(torch, ck, dens):
    """(c): the one-channel B6 on the (128, 512, 257) x-slab at kx0 = 128
    of the dens correlation half-volume (as the sharded two-point
    correlation bins it on rank 1 of 4) against its plain twin on the
    same float32 values in float64, within TOL_BIN of each shell's sum of
    |corr| (the values are signed), timed against its bound."""
    nx, ny, nz = (int(s) for s in dens.shape)
    nbins = min(nx, ny, nz) // 2
    rows, lo = SPECTRAL_SLAB[0], SPECTRAL_SLAB[0]
    fh = torch.fft.rfftn(dens - dens.double().mean().float(), norm="forward")
    corr = torch.fft.irfftn(fh.real.square() + fh.imag.square(), s=(nx, ny, nz), norm="forward")
    del fh
    p = corr[lo : lo + rows, :, : nz // 2 + 1].contiguous()
    del corr
    if tuple(p.shape) != SPECTRAL_SLAB:
        fail(f"phase 28 B6 slab {tuple(p.shape)}, expected {SPECTRAL_SLAB}")
    got = ck.shell_bin_values_rfft_chunk(p, None, nbins, nx, nz, lo)
    torch.cuda.synchronize()
    p64 = p.double()
    ref = ck._shell_bin_unfolded_plain(p64, None, nbins, nz, lo, nx)
    ref_abs = ck._shell_bin_unfolded_plain(p64.abs(), None, nbins, nz, lo, nx)
    del p64
    if got.shape != (1, nbins):
        fail(f"the one-channel B6 gave {tuple(got.shape)}")
    err = (got - ref).abs()
    ratio = float((err / (TOL_BIN * ref_abs).clamp(min=1e-300)).max())
    inside = inside_cells(ck, p, nbins, full_nz=nz, kx0=lo, full_nx=nx)
    return kernel_row(torch, 28,
                      f"one-channel B6 on the correlation x-slab {SPECTRAL_SLAB} at kx0 {lo}",
                      float(err.max()), ratio, TOL_BIN,
                      lambda: ck.shell_bin_values_rfft_chunk(p, None, nbins, nx, nz, lo),
                      lambda: ck._shell_bin_unfolded_plain(p, None, nbins, nz, lo, nx),
                      (4 * inside + 8 * nbins, 4 * inside))


def phase_ranklocal_spectral(torch, np, workdir: Path, card: str):
    """Phase 28 (after phase 27, on phase 8's 512^3 window): a one-rank
    NCCL world on cuda:0 and the (1,) "space" mesh. (a) The six analyses
    of A11f.1 through their ops entries with ``mesh=`` the (1,) mesh and
    on the single device, with exact launches (the one-channel B6 once
    for the two-point correlation on the mesh; K3 + the one-channel B4 on
    the single device; none for the others), held to each other, with
    warm walls; (b) their ranked bodies on d = 2, 4, 8 virtual ranks
    against the single device; (c) the one-channel B6 on a correlation
    x-slab against its plain twin and its bound."""
    import torch.distributed as dist

    import fava_tpu_torch
    from fava_tpu_torch import parallel
    from fava_tpu_torch.ops import coarse_grain, twopoint, velocity
    from fava_tpu_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    times = {"card": card}
    totals = {}
    ops = (coarse_grain, twopoint, velocity, parallel.runtime)
    with tempfile.TemporaryDirectory(prefix="fava_spectral_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=parallel.runtime.COLLECTIVE_TIMEOUT)
        try:
            m1 = parallel.make_device_mesh((1,), device="cuda")
            t0 = time.perf_counter()
            uni = fava_tpu_torch.FLASH(workdir)
            uni.load(file_type="uni", file_index=0, fields=list(NAMES))
            dens = uni.mesh._volume("dens")
            vels = [uni.mesh._volume(f"vel{a}") for a in "xyz"]
            lengths = uni.mesh._domain_lengths()
            times["load_s"] = time.perf_counter() - t0
            pres = dens ** SPECTRAL_GAMMA
            inputs = (dens, pres, vels, lengths)
            vmax = max(float(v.abs().max()) for v in vels)
            ksum = sum(2 * math.pi / L * (int(n) // 2) for L, n in zip(lengths, dens.shape))
            bounds = {"helmholtz decomposition": TOL_SPECTRA * vmax,
                      "vorticity": TOL_IDENTITY * vmax * ksum,
                      "dilatation": TOL_IDENTITY * vmax * ksum}
            times["field_bounds"] = bounds
            t0 = time.perf_counter()
            scales = {
                "filtered ke flux": flux_term_scales(
                    torch, coarse_grain, velocity, vels, dens, None, SPECTRAL_CUTOFFS, "gaussian",
                    lengths),
                "filtered ke flux pressure sharp": flux_term_scales(
                    torch, coarse_grain, velocity, vels, dens, pres, SPECTRAL_PRESSURE_CUTOFFS,
                    "sharp", lengths),
            }
            times["term_scales_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            single, times["single_walls_s"], counts = run_exact_counts(
                torch, ck, 28, spectral_runs(ops, inputs, None, True), "single device")
            add_counts(totals, counts)
            meshed, times["mesh_walls_s"], counts = run_exact_counts(
                torch, ck, 28, spectral_runs(ops, inputs, m1, True), "(1,) mesh")
            add_counts(totals, counts)
            t0 = time.perf_counter()
            times["mesh_errors"] = hold_spectral(torch, np, meshed, single, scales, bounds,
                                                 "(1,) mesh")
            times["mesh_hold_s"] = time.perf_counter() - t0
            times["mesh_over_single"] = {k: times["mesh_walls_s"][k] / times["single_walls_s"][k]
                                         for k in single}
            del meshed
            # The single device's fields on the card, for the virtual ranks.
            on_card = {k: fn() for k, (fn, _) in spectral_runs(ops, inputs, None, False).items()
                       if k in SPECTRAL_FIELDS}
            ref = {**{k: v for k, v in single.items() if k not in SPECTRAL_FIELDS}, **on_card}
            del single
            for d in VIRTUAL_RANKS:
                got, times[f"{d}_ranks_walls_s"], counts = run_exact_counts(
                    torch, ck, 28, virtual_spectral_runs(torch, ops, inputs, d),
                    f"{d} virtual ranks")
                add_counts(totals, counts)
                times[f"{d}_ranks_errors"] = hold_spectral(torch, np, got, ref, scales, bounds,
                                                           f"{d} virtual ranks")
                del got
            del ref, on_card
            torch.cuda.empty_cache()
            row = spectral_b6_row(torch, ck, dens)
            del uni, dens, vels, pres, inputs
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 28 rank-local spectral timings: {json.dumps(times)}")
    if times["phase_s"] > 60:
        fail(f"phase 28 took {times['phase_s']:.1f} s, over its 60 s")
    return totals, row


# ---------------------------------------------------------------------------
# Phase 29: the rank-local flame surface, projections, AMR-side PDFs and
# point sampling (A11f.2) in a one-rank NCCL world

# The (1,) mesh and the virtual ranks against the single device, on the
# window's float32 values: the gradients are the same float32 differences
# on every decomposition (the halo planes are the neighbours' own rows),
# so sigma, the area, the maps and the PDFs' float64 sums differ only by
# their order: TOL_RANKLOCAL of each result's largest value; the maximum
# gradient, the sampled values, the counts and the MIN/MAX edges exactly;
# the weighted bin sums TOL_WSUM per bin; the density PDF's edges come
# from float64 means in the slabs' order, so its counts are equal on the
# mesh and may move at most TOL_SHIFT samples on the virtual ranks.
SURFACE_SLAB = (128, 512, 512)  # (c): rank 1 of 4's x-slab of the window
SURFACE_POINTS = 10_000
SURFACE_SEED = 29


def surface_inputs(torch, np, mesh, flm):
    """The phase's inputs on the card: the flam, dens and velx volumes,
    the window as a (1, nx, ny, nz) stack with its cell-volume and mass
    weights, the deltas of each volume, and SURFACE_POINTS seeded cells
    (block 0) with one on every x boundary of the virtual slabs."""
    dens, velx = mesh._volume("dens"), mesh._volume("velx")
    flam = flm.mesh._volume("flam")
    stack = {"dens": dens[None], "velx": velx[None]}
    cv = float(mesh.get_cell_volumes("LEAF")[0])
    wv = torch.full_like(stack["dens"], cv)
    wm = wv * stack["dens"]
    rng = np.random.default_rng(SURFACE_SEED)
    n = int(dens.shape[0])
    cells = rng.integers(0, n, (SURFACE_POINTS, 3))
    cells[: 2 * max(VIRTUAL_RANKS), 0] = np.arange(2 * max(VIRTUAL_RANKS)) * (n // (2 * max(VIRTUAL_RANKS)))
    deltas = {}
    for key, m in (("flam", flm.mesh), ("window", mesh)):
        lengths = m._domain_lengths()
        deltas[key] = [L / s for L, s in zip(lengths, (m.nxb, m.nyb, m.nzb))]
    return flam, dens, velx, stack, wv, wm, deltas, np.zeros(SURFACE_POINTS, np.int64), cells


def surface_runs(ops, inputs, ranks_of, d=None):
    """{name: (fn, exact launches)} of the slice through its ops entries
    with ``mesh`` (``ranks_of`` the mesh or None: the single device), or,
    with ``d``, its ranked bodies on d virtual ranks' x-slabs (views)."""
    flame, projection, volume, runtime = ops
    flam, dens, velx, stack, wv, wm, deltas, blk, cells = inputs
    if d is None:
        mesh = ranks_of
        return {
            "flame surface x": (lambda: flame.flame_surface(flam, deltas["flam"], axis=0,
                                                            mesh=mesh), {}),
            "flame surface y": (lambda: flame.flame_surface(flam, deltas["flam"], axis=1,
                                                            mesh=mesh), {}),
            "projection dens x": (lambda: projection.project_uniform(dens, deltas["window"],
                                                                     axis=0, mesh=mesh), {}),
            "projection velx by dens z": (lambda: projection.project_uniform(
                velx, deltas["window"], axis=2, weight=dens, mesh=mesh), {}),
            "amr pdf1d volume": (lambda: volume.pdf1d(stack["velx"], weights=wv, mesh=mesh), {}),
            "amr pdf2d volume": (lambda: volume.pdf2d(stack["dens"], stack["velx"], weights=wv,
                                                      mesh=mesh), {"pdf2d_weighted": 1}),
            "amr pdf2d mass": (lambda: volume.pdf2d(stack["dens"], stack["velx"], weights=wm,
                                                    mesh=mesh), {"pdf2d_weighted": 1}),
            "amr pdf2d": (lambda: volume.pdf2d(stack["dens"], stack["velx"], mesh=mesh),
                          {"pdf2d_counts": 1}),
            "amr binned statistic volume": (lambda: volume.binned_statistic(
                stack["dens"], stack["velx"], weights=wv, mesh=mesh), {}),
            "amr density pdf volume": (lambda: volume.density_pdf(stack["dens"], weights=wv,
                                                                  mesh=mesh), {}),
            "sample fields": (lambda: volume.sample_points_ranked(
                [[stack["dens"]], [stack["velx"]]], runtime.SpaceRanks(mesh), blk, cells)
                .cpu().numpy(), {}),
        }
    ranks = runtime.SpaceRanks(d=d)
    n = int(dens.shape[0]) // d

    def cut(t, dim=0):
        return [t.narrow(dim, r * n, n) for r in range(d)]

    st = {k: cut(v, 1) for k, v in stack.items()}
    shape = tuple(flam.shape)
    return {
        "flame surface x": (lambda: flame.flame_surface_ranked(cut(flam), ranks, deltas["flam"],
                                                               shape, 0), {}),
        "flame surface y": (lambda: flame.flame_surface_ranked(cut(flam), ranks, deltas["flam"],
                                                               shape, 1), {}),
        "projection dens x": (lambda: projection.project_uniform_ranked(
            cut(dens), ranks, deltas["window"], 0).cpu().numpy(), {}),
        "projection velx by dens z": (lambda: projection.project_uniform_ranked(
            cut(velx), ranks, deltas["window"], 2, cut(dens)).cpu().numpy(), {}),
        "amr pdf1d volume": (lambda: volume.pdf1d_ranked(st["velx"], ranks, weights=cut(wv, 1)),
                             {}),
        "amr pdf2d volume": (lambda: volume.pdf2d_ranked(st["dens"], st["velx"], ranks,
                                                         weights=cut(wv, 1)),
                             {"pdf2d_weighted": d}),
        "amr pdf2d mass": (lambda: volume.pdf2d_ranked(st["dens"], st["velx"], ranks,
                                                       weights=cut(wm, 1)),
                           {"pdf2d_weighted": d}),
        "amr pdf2d": (lambda: volume.pdf2d_ranked(st["dens"], st["velx"], ranks),
                      {"pdf2d_counts": d}),
        "amr binned statistic volume": (lambda: volume.binned_statistic_ranked(
            st["dens"], st["velx"], ranks, weights=cut(wv, 1)), {}),
        "amr density pdf volume": (lambda: volume.density_pdf_ranked(st["dens"], ranks,
                                                                     weights=cut(wv, 1)), {}),
        "sample fields": (lambda: volume.sample_points_ranked(
            [st["dens"], st["velx"]], ranks, blk, cells).cpu().numpy(), {}),
    }


def surface_error(np, name, g, r, same_edges, unit):
    """error/bound of one result of the slice against the single device's
    (the phase's comment); ``unit`` is the weight of one sample of the
    volume-weighted density PDF (the cell volume)."""
    if name.startswith("flame surface"):
        if not (np.array_equal(g["x"], r["x"]) and g["max_gradient"] == r["max_gradient"]):
            fail(f"phase 29 {name}: x or max_gradient differs from the single device's")
        errs = [abs(g[k] - r[k]) / abs(r[k]) for k in ("area", "wrinkling")]
        errs.append(float(np.abs(g["sigma"] - r["sigma"]).max() / np.abs(r["sigma"]).max()))
        return max(errs) / TOL_RANKLOCAL
    if name.startswith("projection"):
        return float(np.abs(g - r).max() / np.abs(r).max()) / TOL_RANKLOCAL
    if name == "sample fields":
        return 0.0 if np.array_equal(g, r) else float("inf")
    edges = [k for k in r if k.endswith("edges")]
    weighted = name.endswith(("volume", "mass")) and "binned" not in name
    if name.startswith("amr density pdf"):
        sigma = r["sigma_s"]
        errs = [abs(g[k] - r[k]) / max(abs(r[k]), sigma)
                for k in ("rho_mean", "mean_s", "sigma_s", "skewness", "excess_kurtosis")]
        errs.append(float(np.abs(g["edges"] - r["edges"]).max() / (r["edges"][-1] - r["edges"][0])))
        excess = np.abs(g["counts"] - r["counts"]) - TOL_WSUM * np.abs(r["counts"])
        moved = float(np.clip(excess, 0.0, None).sum()) / 2 / unit
        if same_edges and moved:
            fail(f"phase 29 {name}: counts differ from the single device's on the mesh")
        return max(max(errs) / TOL_RANKLOCAL, moved / TOL_SHIFT)
    if not all(np.array_equal(g[k], r[k]) for k in edges):
        fail(f"phase 29 {name}: other edges than the single device's (an exact MIN/MAX join)")
    if weighted:
        return float((np.abs(g["counts"] - r["counts"])
                      / (TOL_WSUM * np.abs(r["counts"])).clip(1e-300)).max())
    if not np.array_equal(g["counts"], r["counts"]):
        fail(f"phase 29 {name}: counts differ from the single device's")
    if "binned" in name:
        return max(float(np.nanmax(np.abs(g[k] - r[k])) / np.nanmax(np.abs(r[k])))
                   for k in ("mean", "std")) / TOL_RANKLOCAL
    return 0.0


def hold_surface(np, got, ref, what, same_edges, unit):
    """Each result of the slice against the single device's, worst
    error/bound printed; fails above 1."""
    worst = {name: surface_error(np, name, got[name], r, same_edges, unit)
             for name, r in ref.items()}
    top = max(worst, key=worst.get)
    say(f"phase 29 {what} vs the single device: worst error/bound {worst[top]!r} ({top}); "
        f"{json.dumps(worst)}")
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        fail(f"{what} disagrees with the single device (error/bound): {bad}")
    return worst


def phase_ranklocal_surface(torch, np, workdir: Path, card: str):
    """Phase 29 (after phase 28, on phase 8's 512^3 window and phase 19's
    flam window): a one-rank NCCL world on cuda:0 and the (1,) "space"
    mesh. (a) The flame surface (x and y), the projections (dens along x,
    velx weighted by dens along z), the four AMR-side PDFs on the window
    as a (1, 512, 512, 512) stack with its cell-volume (and mass)
    weights, and the sampling of SURFACE_POINTS seeded cells, each
    through its ops entry with ``mesh=`` the (1,) mesh and on the single
    device, with exact launches (B8 once per pdf2d, nothing else), held
    to each other, with warm walls; (b) their ranked bodies on d = 2, 4,
    8 virtual ranks (B8 d times per pdf2d) against the single device; (c)
    the weighted B8 on one (128, 512, 512) slab's samples against its
    plain twin and its bound."""
    import torch.distributed as dist

    import fava_tpu_torch
    from fava_tpu_torch import parallel
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import flame, projection, volume

    t_phase = time.perf_counter()
    times = {"card": card}
    totals = {}
    ops = (flame, projection, volume, parallel.runtime)
    with tempfile.TemporaryDirectory(prefix="fava_surface_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=parallel.runtime.COLLECTIVE_TIMEOUT)
        try:
            m1 = parallel.make_device_mesh((1,), device="cuda")
            t0 = time.perf_counter()
            uni = fava_tpu_torch.FLASH(workdir)
            uni.load(file_type="uni", file_index=0, fields=["dens", "velx"])
            flm = fava_tpu_torch.FLASH(workdir / "flam")
            flm.load(file_type="uni", fields=["flam"])
            inputs = surface_inputs(torch, np, uni.mesh, flm)
            times["load_s"] = time.perf_counter() - t0
            single, times["single_walls_s"], counts = run_exact_counts(
                torch, ck, 29, surface_runs(ops, inputs, None), "single device")
            add_counts(totals, counts)
            meshed, times["mesh_walls_s"], counts = run_exact_counts(
                torch, ck, 29, surface_runs(ops, inputs, m1), "(1,) mesh")
            add_counts(totals, counts)
            unit = float(inputs[4].reshape(-1)[0])
            times["mesh_errors"] = hold_surface(np, meshed, single, "(1,) mesh", True, unit)
            times["mesh_over_single"] = {k: times["mesh_walls_s"][k] / times["single_walls_s"][k]
                                         for k in single}
            del meshed
            for d in VIRTUAL_RANKS:
                got, times[f"{d}_ranks_walls_s"], counts = run_exact_counts(
                    torch, ck, 29, surface_runs(ops, inputs, None, d), f"{d} virtual ranks")
                add_counts(totals, counts)
                times[f"{d}_ranks_errors"] = hold_surface(np, got, single, f"{d} virtual ranks",
                                                          False, unit)
                del got
            _flam, dens, velx, _stack, wv, _wm, _deltas, _blk, _cells = inputs
            lo, rows = SURFACE_SLAB[0], SURFACE_SLAB[0]
            x, y, w = (t[lo : lo + rows].contiguous() for t in (dens, velx, wv[0]))
            if tuple(x.shape) != SURFACE_SLAB:
                fail(f"phase 29 B8 slab {tuple(x.shape)}, expected {SURFACE_SLAB}")
            name, row = check_pdf2d_kernel(torch, np, ck, 29, x, y, w)
            del uni, flm, inputs, single, dens, velx, wv, x, y, w
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    times["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 29 rank-local surface timings: {json.dumps(times)}")
    if times["phase_s"] > 60:
        fail(f"phase 29 took {times['phase_s']:.1f} s, over its 60 s")
    return totals, {"name": name, "slab": SURFACE_SLAB, **row}


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

    t_start = time.perf_counter()
    card = phase_device(torch)
    build_s = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fava_tpu_torch import flagship

    from fava_tpu_torch.utils import timing

    timing.VERBOSE = False
    fields = flagship.make_example_fields(N)
    rows = phase_kernels(torch, fields)
    launches, _errs, model, batch, ref_spectra = phase_main(torch, np, fields)
    stages = phase_timings(torch, fields, model, batch, card)
    del model, batch
    torch.cuda.empty_cache()
    fused_rows, fused_launches, fused_times = phase_fused(torch, np, fields, ref_spectra)
    rows.update(fused_rows)
    add_counts(launches, fused_launches)
    say(f"phase 18 fused-spectrum timings: {json.dumps({'card': card, **fused_times})}")
    del fields, ref_spectra
    torch.cuda.empty_cache()
    wide_kernels, wide_times, wide_launches = phase_wide_walk(torch, np)
    add_counts(launches, wide_launches)
    say(f"phase 20 wide-walk timings: {json.dumps({'card': card, 'kernels': wide_kernels, **wide_times})}")
    torch.cuda.empty_cache()

    rows["shell_bin_values_rfft_chunk"], stream_launches, stream_times = phase_streamed(torch, np)
    add_counts(launches, stream_launches)
    torch.cuda.empty_cache()
    beyond_launches, beyond_times = phase_beyond_incore(torch, np)
    add_counts(launches, beyond_launches)
    say(f"phase 13-15 streamed timings: {json.dumps({'card': card, **stream_times, **beyond_times})}")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="fava_amr_") as tmp:
        workdir = Path(tmp)
        amr_model, amr_times = phase_amr_file(torch, np, workdir)
        amr_rows, full_ms = phase_amr_kernels(torch, np, amr_model.mesh)
        amr_times["regrid_full_domain_dens_ms"] = full_ms
        rows.update(amr_rows)
        amr_launches, window_ms, path_times, pdf2d_row, amr4_launches = phase_amr_path(
            torch, np, amr_model, workdir)
        del amr_model
        rows["regrid_fields"] = window_ms
        rows[pdf2d_row[0]] = pdf2d_row[1]
        launches.update(amr_launches)
        amr_times.update(path_times)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        )
        amr_times.update({"card": card, "nvidia_smi_after": smi.stdout.strip()})
        say(f"phase 9 AMR timings: {json.dumps(amr_times)}")
        torch.cuda.empty_cache()

        uni, cpu, win_rows, win_times, win_launches = phase_window_stage4(torch, np, workdir)
        rows.update(win_rows)
        odd_rows, odd_times, odd_launches = phase_odd_extents(torch, np, uni, cpu)
        rows.update(odd_rows)
        fs_times, fs_launches = phase_fractal_structure(torch, np, workdir, uni, cpu)
        add_counts(launches, fs_launches)
        say(f"phase 19 fractal and structure timings: {json.dumps({'card': card, **fs_times})}")
        surface_times = window_surface_projection(torch, np, workdir, uni, cpu)
        del uni
        torch.cuda.empty_cache()
        entry_launches, entry_times = phase_entry_point(torch, np, workdir, cpu)
        del cpu
        series_launches, series_times = phase_series(torch, np, workdir)
        torch.cuda.empty_cache()
        velocity_launches, _ = phase_velocity(torch, np, workdir, card)
        torch.cuda.empty_cache()
        a8c_launches, _ = phase_a8c(torch, np, workdir, card)
        torch.cuda.empty_cache()
        sharded_launches = phase_sharded(torch, np, workdir, card)
        torch.cuda.empty_cache()
        pod_launches = phase_pod(torch, np, workdir, card)
        torch.cuda.empty_cache()
        ranklocal_launches, rows[RANKLOCAL_B6] = phase_ranklocal(torch, np, workdir, card)
        torch.cuda.empty_cache()
        spectral_launches, spectral_b6 = phase_ranklocal_spectral(torch, np, workdir, card)
        say(f"phase 28 one-channel B6 on the correlation x-slab: {json.dumps(spectral_b6)}; {card}")
        torch.cuda.empty_cache()
        surface_launches, surface_b8 = phase_ranklocal_surface(torch, np, workdir, card)
        say(f"phase 29 weighted B8 on the window's x-slab: {json.dumps(surface_b8)}; {card}")
    torch.cuda.empty_cache()
    pipe_launches, pipe_times = phase_pipeline(torch, np)
    for counts in (amr4_launches, win_launches, odd_launches, entry_launches, series_launches,
                   velocity_launches, a8c_launches, sharded_launches, pod_launches,
                   ranklocal_launches, spectral_launches, surface_launches, pipe_launches):
        add_counts(launches, counts)
    say(f"phase 11-12 stage-4 timings: {json.dumps({'card': card, 'window': win_times, 'odd': odd_times})}")
    say(f"phase 16-17 entry point and series timings: "
        f"{json.dumps({'card': card, 'entry': entry_times, 'series': series_times})}")
    say(f"phase 21 pipeline timings: "
        f"{json.dumps({'card': card, 'window': surface_times, 'pipeline': pipe_times})}")
    torch.cuda.empty_cache()
    phase_particles(torch, np, card)
    torch.cuda.empty_cache()
    # Phase 30 runs last: CUPTI stays attached after a trace, and every
    # later CUDA call of the process pays host time for it.
    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, flagship.make_example_fields(N))))
    add_counts(launches, phase_trace(torch, np, model, stages, card))
    del model

    if any(m.split(".")[0] in ("jax", "fava_tpu") for m in sys.modules):
        fail("JAX or fava_tpu was imported")
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], **rows[name]}
        for name in REPLACES
    ]
    say(f"smoke seconds {time.perf_counter() - t_start!r}; build seconds {build_s!r}; {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
