"""Build and bind the hand-written CUDA kernels.

Each ``fava_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process for Hopper (``sm_90a``), all started together, and the objects
are linked into one shared library with a plain C interface, loaded
with ctypes. The build happens at first use, into
``fava_tpu_torch/_build/``, keyed by a hash of the sources, headers and
flags, so a fresh checkout builds once and later processes reuse the
library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "fava_row_moments": (_P, _P, _P, _P, _P, _LL, _LL, _I, _P),
    "fava_centered_row_moments": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P),
    "fava_fold_quadrants_pair": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "fava_shell_bin_values_folded": (_P, _P, _P) + (_I,) * 8 + (_P,),
    "fava_block_row_moments": (_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P),
    "fava_block_centered_row_moments": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _P),
    "fava_regrid_fields": (_P, _P, _I, _P, _P, _P) + (_LL,) * 14 + (_I, _I, _P),
    "fava_regrid_blocks_per_sm": (_I,),
    "fava_shell_bin_sums_unfolded": (_P, _P, _P) + (_I,) * 7 + (_P,),
    "fava_shell_bin_sums_rfft_chunk": (_P, _P, _P) + (_I,) * 9 + (_P,),
    "fava_shell_bin_unfolded_blocks_per_sm": (_I, _I),
    "fava_pdf2d": (_P,) * 5 + (_LL, _I, _I, _I, _I, _LL, _I, _P),
    "fava_pdf2d_blocks_per_sm": (_I, _I, _LL),
    "fava_pdf2d_smem_optin": (),
    "fava_shell_bin_sums_folded_onepass": (_P, _P, _P) + (_I,) * 8 + (_P,),
    "fava_shell_bin_folded_blocks_per_sm": (_I, _I, _I),
    "fava_shell_bin_powers_fused": (_P, _P, _P) + (_I,) * 7 + (_P,),
    "fava_shell_bin_powers_fused_blocks_per_sm": (_I, _I),
    "fava_zy_rfft": (_P, _P, _P, _I, _I, _I, _P),
    "fava_zy_fft": (_P, _P, _P, _P, _I, _P, _I, _P),
    "fava_zy_fft_tables": (_P, _P, _P),
    "fava_zy_fft_table_bytes": (_P,),
    "fava_zy_fft_clusters": (_P,),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the CUDA "
        "kernels of fava_tpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfava_kernels_{h.hexdigest()[:16]}.so"


BUILD_LOG: Optional[str] = None


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    One nvcc per source, all running at once, then one link. Raises when
    nvcc is missing or a compile or the link fails. The compilers'
    resource reports (``-Xptxas -v``) are kept in ``BUILD_LOG``.
    """
    global BUILD_LOG
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs, failed = [], []
        for src, proc in zip(_sources(), procs):
            logs.append(f"== {src.name}\n{proc.communicate()[0]}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{BUILD_LOG}")
        tmp = Path(work) / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
        )
        BUILD_LOG += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
    return out


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with every entry's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fava_error_string.argtypes = [ctypes.c_int]
    lib.fava_error_string.restype = ctypes.c_char_p
    return lib
