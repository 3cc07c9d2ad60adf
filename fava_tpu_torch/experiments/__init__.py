"""The fused-spectrum path: counterpart of fava_tpu/experiments/.

fava_tpu fenced these modules off as measured-negative experiments: on
the TPU they lost to its production path (fused z+y transform 88.7 vs
67.0 ms at 512^3; planar stacked transforms 116 vs 113 ms). Those verdicts
are fava_tpu's history, measured on a TPU, and say nothing of the port;
the port's numbers come from ``chip_smoke.py`` on the H100 (PERF.md).
The port carries the modules because they run fava_tpu's fused-spectrum
paths: the fused z-rfft + y-DFT (B12, ``ops.cuda_kernels.zy_rfft_planar``)
and fava_tpu's first two folded binning kernels (B11), which only its
tests and probes reached, and the stacked transforms into the fused
powers + fold + shell binning (B9, ``ops.cuda_kernels.shell_bin_powers_fused``).
Nothing in ``fava_tpu_torch.ops`` or the analyses imports from here;
the main path (``ops.spectra.rfft_shell_sums``) bins with B9 too, for
even x and y extents.

Contents:
  planar_dft  -- stacked rfft of the three velocity volumes (one cuFFT
                 call) and ``rfft_shell_sums_fused``, the fused-spectrum
                 path: transforms -> B9 -> (counts, sums[3]);
                 ``rfft_shell_sums_fused_zy``, the same with B12's
                 transforms
  fused_dft   -- the fused z+y transform (B12) and ``rfftn_fused``
                 (B12, then cuFFT along x)
  folded_bins -- the spectra through fava_tpu's padded fold into the
                 one-pass or the row-chunked folded binning (B11), the
                 path of its binning probes
"""
