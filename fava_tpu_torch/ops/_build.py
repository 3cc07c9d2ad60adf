"""Build and bind the hand-written CUDA kernels.

``fava_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded
with ctypes. The build happens at first use, into
``fava_tpu_torch/_build/``, keyed by a hash of the sources and flags,
so a fresh checkout builds once and later processes reuse the library.
Nothing here runs at import time.
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
    "-shared",
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
    "fava_shell_bin_values_folded": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfava_kernels_{h.hexdigest()[:16]}.so"


BUILD_LOG: Optional[str] = None


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Raises when nvcc is missing or the compile fails. The compiler's
    resource report (``-Xptxas -v``) is kept in ``BUILD_LOG``.
    """
    global BUILD_LOG
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
