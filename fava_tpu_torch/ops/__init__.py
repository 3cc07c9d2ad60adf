"""Device operations: spectra, profile assembly and the CUDA kernels."""

from fava_tpu_torch.ops import flame, fractal, profiles, regrid, spectra, structure, volume

__all__ = ["flame", "fractal", "profiles", "regrid", "spectra", "structure", "volume"]
