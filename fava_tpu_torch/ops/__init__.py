"""Device operations: spectra, profile assembly and the CUDA kernels."""
