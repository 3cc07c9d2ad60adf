"""Role: the twiddle and chirp tables of the cluster FFT's plan.

``csrc/dft_kernels.cu`` ``zy_fft_tables_kernel``: launched once a plan,
uncounted by ``launch_counts()``; its work is not counted here.
"""

ROLE = "zy FFT tables"
NAMES = (r"(?<![A-Za-z0-9_])zy_fft_tables_kernel\b",)
COUNTERS = ()


def work(kernel, ctx):
    return None
