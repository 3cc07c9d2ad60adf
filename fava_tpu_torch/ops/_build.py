"""Build and bind the hand-written CUDA kernels.

Each ``fava_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process for Hopper (``sm_90a``), all started together, and the objects
are linked into one shared library with a plain C interface, loaded
with ctypes. The build happens at first use, into ``BUILD_DIR``
(``fava_tpu_torch/_build/`` unless ``utils.enable_compilation_cache``
points it elsewhere), keyed by a hash of the sources, headers and flags,
so a fresh checkout builds once and later processes, and checkouts with
the same sources sharing one directory, reuse the library. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
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
# The library that library() loaded, once it has.
_LOADED: Optional[Path] = None


def set_build_dir(path) -> None:
    """Build into and load from ``path`` from now on. Raises RuntimeError
    once ``library()`` has loaded a library from another directory: that
    library stays loaded in this process."""
    global BUILD_DIR
    path = Path(path).resolve()
    if _LOADED is not None and _LOADED.parent.resolve() != path:
        raise RuntimeError(
            f"the kernel library is already loaded from {_LOADED}; this process cannot "
            f"build into or load from {path}"
        )
    BUILD_DIR = path


def _compile(nvcc: str, src: Path, obj: Path):
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    One nvcc per source, all running at once, then one link. Raises when
    nvcc is missing or a compile or the link fails. ``BUILD_LOG`` keeps,
    for each source, its compile seconds (on its ``== name: s s`` line)
    and the compiler's resource report (``-Xptxas -v``).
    """
    global BUILD_LOG
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in sources]
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            runs = list(pool.map(_compile, [nvcc] * len(sources), sources, objs))
        logs, failed = [], []
        for src, (proc, secs) in zip(sources, runs):
            logs.append(f"== {src.name}: {secs:.1f} s\n{proc.stdout}")
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
    global _LOADED
    path = build()
    lib = ctypes.CDLL(str(path))
    _LOADED = path
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fava_error_string.argtypes = [ctypes.c_int]
    lib.fava_error_string.restype = ctypes.c_char_p
    return lib
