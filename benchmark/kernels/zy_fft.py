"""Role: the real transform along z and the complex transform along y of
every x plane (the fused-spectrum path's z+y transform).

B12 (``csrc/zy_fft.cuh`` ``zy_fft_kernel``, the cluster FFT, and
``csrc/dft_kernels.cu`` ``zy_rfft_kernel``, the dense DFT on no route): a
float32 (nx, ny, nz) volume read once, the real and imaginary float32
(nx, ny, nz/2+1) planes written once; the operations of the transforms
done as FFTs.
"""

from harness.roofline import zy_fft_ops

ROLE = "zy FFT"
NAMES = (r"(?<![A-Za-z0-9_])zy_fft_kernel\b", r"(?<![A-Za-z0-9_])zy_rfft_kernel\b")
COUNTERS = ("zy_rfft_planar", "zy_rfft_planar_dense")


def work(kernel, ctx):
    nx, ny, nz = ctx.shape
    return 4 * nx * ny * nz + 8 * nx * ny * (nz // 2 + 1), zy_fft_ops(nx, ny, nz)
