"""The benchmark of fava_tpu_torch: general code that reads the cell,
metric, kernel-role, generator and reference files by name."""
