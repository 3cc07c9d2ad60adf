#!/usr/bin/env python3
"""Probe of B12's cluster FFT kernel on one NVIDIA GPU.

Run from the repository root:

    python3 probe_zy_fft.py [--quick]

It builds the kernels, prints the FFT kernel's ptxas report, holds the
kernel to the float64 dense DFT (``_zy_rfft_plain``) on small shapes
(power-of-two and mixed-radix plans, odd y and z, every radix, chirp axes
and nz = 1), on sqrt(rho)*v_x of ``make_example_fields(512)`` and its cuts
to 512x512x480, 512x480x512 and 512x384x375 (mixed radix) and to
512x512x502, 512x502x512, 512x509x509 and 512x512x1 (chirp axes, nz = 1),
and on an (8, 1024, 1024) random volume (the two-pass plan), within 1e-5
of the largest coefficient; then times (CUDA events, warm) the kernel
under its plan and under other cluster sizes, passes, shared-memory
budgets, homes of the chirp tables (shared or global memory) and
convolution lengths of a chirp axis, beside the dense kernel (512^3 and
the 512x512x480 and 512x512x502 cuts) and ``torch.fft.rfftn(x, dim=(1,
2))``. ``--quick`` stops after the checks.
``--chirp`` instead times, on the chirp cuts, plans of one and two passes,
both budgets, both homes of the chirp tables and cluster sizes 16 and 8
at each row batch that fits (the results bit-equal to the plan's).
``--parent DIR`` instead times the kernel as built against the build of
DIR/fava_tpu_torch/csrc/dft_kernels.cu (another checkout) under the same
plans, in turns, on the power-of-two, mixed-radix and chirp cuts and nz
= 1, bit for bit.
``--designs`` instead times, in turns, the kernel as built against a build
without its power-of-two route (at 512^3 and (8, 1024, 1024), bit for bit,
with both builds' SASS instruction counts), and each plan against the
plans the kernel would take with fewer register DFTs (at 512x512x480,
512x480x512, 512x384x375, 512x384x384 and 576^2, 640^2, 768^2, 896^2
y-z planes), beside the dense kernel at 512x512x480.
``--phases`` instead times, at 512^3, 512x512x480 and 512x384x375, builds
of the kernel with one phase taken out of the source (their results are
wrong; only their times count), each in turns with the whole build, to
show where the kernel's time goes, after a build that sums each phase's
and each pass's clock64() cycles over the blocks (``--timeline``: that
build alone; ``--variants``: the other whole builds (VARIANTS) alone,
each in turns with the whole build and held to its result bit for bit).
Its last line is all its results as one JSON object.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL_ZY = 1e-5
SMALL = [(2, 2, 2), (3, 64, 32), (1, 1024, 2), (2, 1, 8), (2, 16, 2), (1, 2, 2), (2, 8, 1024),
         (4, 1024, 8), (2, 512, 512), (2, 45, 35), (2, 3, 9), (2, 7, 7), (2, 1, 3), (3, 12, 14),
         (3, 10, 20), (2, 27, 18), (2, 15, 30), (2, 6, 12), (2, 49, 343), (2, 375, 6), (1, 1000, 1000),
         (2, 768, 768), (2, 640, 640), (4, 96, 768),
         # chirp axes: y, z (even and odd), both, nz = 1, the 2048-point convolution
         (2, 22, 26), (2, 17, 38), (2, 13, 33), (2, 11, 1), (1, 1, 1), (2, 16, 1), (2, 64, 33),
         (2, 22, 502), (1, 509, 8), (3, 11, 22), (2, 1, 11), (2, 502, 8), (2, 33, 64), (2, 127, 127),
         (4, 512, 1), (1, 1021, 1019), (1, 1019, 1021)]


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Text edits of one_unit()'s source that take one phase out of the FFT kernel.
LOAD = "return vec ? __ldg(reinterpret_cast<const float2*>(q)) : make_float2(__ldg(q), __ldg(q + 1));"
REMOTE = "cluster.map_shared_rank(cols, u - pass * c)"
ARRIVE = 'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");'
WAIT = 'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");'
CUTS = {
    "z transform": [("fft_run<P2>(rows_in, rows_mid, rows_mid, nt, rz, p.nrz, dvs + kDvZ, slotd, "
                     "odd ? (nb + 1) >> 1 : nb, twpz);", "")],
    "post-process": [("e < nb * wp;", "e < 0;")],
    "y transform": [("fft_run<P2>(cols_mid, cols_mid, cols_out, ny, ry, p.nry, dvs + kDvY, "
                     "divisor<P2>(tw, dvs, kDvRank, kDvRankHi),\n                  tw, twpy);", "")],
    "output stores": [("re[o] = v.x;\n    im[o] = v.y;", "")],
    "DSMEM (local stores)": [(REMOTE, "cols")],
    "DSMEM and cluster barriers": [(REMOTE, "cols"), ('asm volatile("barrier.cluster', '// ('),
                                   ("  cluster.sync();\n", "  __syncthreads();\n")],
    "global loads": [(LOAD, "return make_float2((float)s, (float)e);")],
    "global loads and stores": [(LOAD, "return make_float2((float)s, (float)e);"),
                                ("re[o] = v.x;\n    im[o] = v.y;", "")],
}
# Other builds of the whole kernel, timed beside it (their results are held
# to this checkout's bit for bit).
VARIANTS = {
    "passes not inlined": [("template <int R, bool P2, bool Dit = false, class Src, class Dst>\n"
                            "__device__ void fft_pass(",
                            "template <int R, bool P2, bool Dit = false, class Src, class Dst>\n"
                            "__device__ __noinline__ void fft_pass(")],
    "transforms called": [("template <bool P2, class Src, class Dst>\n__device__ __forceinline__ void fft_run(",
                           "template <bool P2, class Src, class Dst>\n__device__ __noinline__ void fft_run(")],
    "no minimum of two blocks an SM": [("__launch_bounds__(kFftThreads, 2)\nzy_fft_kernel(",
                                        "__launch_bounds__(kFftThreads)\nzy_fft_kernel(")],
    "pass offsets by multiplies": [("(P2 ? subd.mul(g * R) : g * L)", "g * L"), ("subd.mul(t)", "t * subd.d")],
}


# Text edits that make each block add its phases' clock64() spans to a
# device array (cycles summed over blocks); fava_zy_timeline copies it out.
SPANS = ("tables", "z transforms", "post-process", "barrier", "y transforms")
PASS_SPANS = tuple(f"{axis} pass {i}" for axis in "zy" for i in range(4))
TIMELINE = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <type_traits>\n"),
    ("// An nt-point transform of nseq sequences",
     "__device__ unsigned long long zy_timeline[16];\n// An nt-point transform of nseq sequences"),
    ("  int L = nt;\n  for (int i = 0; i < nst; ++i) {\n",
     "  int L = nt;\n  for (int i = 0; i < nst; ++i) {\n    const long long tp_ = clock64();\n"),
    ("    L = subd.d;\n    __syncthreads();\n",
     "    L = subd.d;\n    __syncthreads();\n    if (threadIdx.x == 0) atomicAdd(&zy_timeline["
     "(std::is_same<Src, SmemSeq>::value ? 12 : 8) + i], (unsigned long long)(clock64() - tp_));\n"),
    ("  // Every block of the cluster has started once this barrier's wait\n",
     "  long long tk[8] = {}; long long t_ = clock64();\n  // Every block of the cluster has started once this barrier's wait\n"),
    ("  // Phase 1: this rank's rows", "  tk[0] += clock64() - t_; t_ = clock64(); tk[7] = 1;\n  // Phase 1: this rank's rows"),
    ("odd ? (nb + 1) >> 1 : nb, twpz);\n", "odd ? (nb + 1) >> 1 : nb, twpz);\n    tk[1] += clock64() - t_; t_ = clock64();\n"),
    ("    __syncthreads();\n  }\n  // Every rank's stores",
     "    __syncthreads();\n    tk[2] += clock64() - t_; t_ = clock64();\n  }\n  // Every rank's stores"),
    ("  cluster.sync();\n\n  // Phase 2", "  cluster.sync();\n  tk[3] += clock64() - t_; t_ = clock64();\n\n  // Phase 2"),
    ("\n}\n\n}  // namespace\n\nnamespace fava_zy {",
     "\n  tk[4] += clock64() - t_;\n  if (threadIdx.x == 0) { for (int i = 0; i < 5; ++i) atomicAdd(&zy_timeline[i], "
     "(unsigned long long)tk[i]); atomicAdd(&zy_timeline[6], 1ull); atomicAdd(&zy_timeline[7], "
     "(unsigned long long)tk[7]); }\n}\n\n}  // namespace\n\nnamespace fava_zy {"),
    ('}  // extern "C"', 'int fava_zy_timeline(void* out) { return (int)cudaMemcpyFromSymbol(out, zy_timeline, '
     '16 * sizeof(unsigned long long)); }\n}  // extern "C"'),
]


def one_unit(root: Path) -> str:
    """The dft kernels of the checkout at ``root`` as one translation unit:
    dft_kernels.cu with zy_fft.cuh in place of its include and the builds'
    sources (zy_fft_*.cu) after it, where the checkout has them."""
    csrc = root / "fava_tpu_torch" / "csrc"
    src = (csrc / "dft_kernels.cu").read_text()
    if (csrc / "zy_fft.cuh").is_file():
        head = (csrc / "zy_fft.cuh").read_text().replace("#pragma once\n", "")
        src = src.replace('#include "zy_fft.cuh"\n', head)
        for unit in sorted(csrc.glob("zy_fft_*.cu")):
            src += unit.read_text().replace('#include "zy_fft.cuh"\n', "")
    return src


def build_variant(nvcc, flags, edits, work: Path, root: Path = HERE):
    """The dft kernels' library of the checkout at ``root`` with ``edits``
    applied to its source, built as one translation unit (one_unit)."""
    src = one_unit(root)
    for old, new in edits:
        if old not in src:
            sys.exit(f"edit target not found: {old!r}")
        src = src.replace(old, new)
    for h in (root / "fava_tpu_torch" / "csrc").glob("*.cuh"):
        shutil.copy(h, work / h.name)
    (work / "k.cu").write_text(src)
    lib = work / "k.so"
    subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(work / "k.cu")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.fava_zy_fft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                                      ctypes.c_void_p]
    so.fava_zy_fft.restype = ctypes.c_int
    so.fava_zy_fft_tables.argtypes = [ctypes.c_void_p] * 3
    so.fava_zy_fft_table_bytes.argtypes = [ctypes.c_void_p]
    return so


def timeline(torch, ck, _build, x):
    """Mean clock64() cycles of each phase of the FFT kernel per block and
    item (the tables per block)."""
    plan = ck._zy_fft_plan(int(x.shape[1]), int(x.shape[2]))
    ints = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
    re, im = ck._zy_outputs(x)
    tables = ck._zy_fft_tables(plan, str(x.device)).data_ptr()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        so = build_variant(_build.find_nvcc(), flags, TIMELINE, Path(tmp))
        so.fava_zy_timeline.argtypes = [ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):  # the second run adds to the first's sums: halve below
            if so.fava_zy_fft(x.data_ptr(), re.data_ptr(), im.data_ptr(), tables, int(x.shape[0]),
                              ctypes.addressof(ints), 1, stream):
                sys.exit("timeline build: launch failed")
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 16)()
        if so.fava_zy_timeline(ctypes.addressof(sums)):
            sys.exit("timeline build: copy failed")
    blocks, block_items = sums[6], sums[7]  # per block, and per block and item
    out = {"tables (per block)": sums[0] / blocks}
    out.update({name: sums[i] / block_items for i, name in enumerate(SPANS) if i})
    out.update({name: sums[8 + i] / block_items for i, name in enumerate(PASS_SPANS) if sums[8 + i]})
    out["blocks"], out["items per block"] = blocks // 2, block_items / blocks
    print(f"timeline, mean cycles per block and item: {json.dumps(out)}", flush=True)
    return out


def phase_times(torch, ck, _build, volumes):
    """ms of the FFT kernel on each of ``volumes`` in each other build (each
    phase cut, not with ``--variants``, then VARIANTS), timed in turns with
    the whole build: whole, other, other, whole; each build once."""
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    runs = []
    for name, x in volumes:
        plan = ck._zy_fft_plan(int(x.shape[1]), int(x.shape[2]))
        ints = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
        ref = ck.zy_rfft_planar(x)
        runs.append((name, x, ints, ck._zy_fft_tables(plan, str(x.device)).data_ptr(), ck._zy_outputs(x), ref))
    out = {name: {} for name, *_ in runs}
    stream = torch.cuda.current_stream().cuda_stream

    def runner(so, vname, x, ints, tables, re, im):
        def run():
            err = so.fava_zy_fft(x.data_ptr(), re.data_ptr(), im.data_ptr(), tables, int(x.shape[0]),
                                 ctypes.addressof(ints), 1, stream)
            if err:
                sys.exit(f"{vname}: launch error {err}")
        return run

    with tempfile.TemporaryDirectory() as tmp:
        cuts = {} if "--variants" in sys.argv else {f"without {k}": v for k, v in CUTS.items()}
        whole = None
        for i, (vname, edits) in enumerate({"whole": [], **cuts, **VARIANTS}.items()):
            work = Path(tmp) / str(i)
            work.mkdir()
            so = build_variant(nvcc, flags, edits, work)
            whole = whole or so
            for name, x, ints, tables, (re, im), ref in runs:
                if so is whole:
                    continue
                this = runner(so, vname, x, ints, tables, re, im)
                base = runner(whole, "whole", x, ints, tables, re, im)
                t = [cuda_ms(torch, f, 20) for f in (base, this, this, base)]
                this()
                torch.cuda.synchronize()
                same = bool(torch.equal(re, ref[0]) and torch.equal(im, ref[1]))
                out[name][vname] = {"ms": t[1:3], "whole_ms": [t[0], t[3]], "bit_equal": same}
                print(f"build {vname!r} on {name}: {t[1]!r}, {t[2]!r} ms beside whole {t[0]!r}, {t[3]!r}; "
                      f"bit-equal {same}", flush=True)
    return out


def rel_err(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    return err / scale


# The design probe (--designs): the kernel with its power-of-two route taken
# out (every plan through the divisors of its tables), and plans with
# fewer register DFTs.
NO_POW2_ROUTE = [("return pow2(p.ny) && pow2(p.nz) && p.nz > 1 && pow2(p.batch) ? kPow2 : kMixed;",
                  "return kMixed;")]
BASE_RADICES = (2, 3, 4, 5, 7, 8, 16)
SASS_OPS = ("IMAD", "SHF", "LEA", "IADD3", "FFMA", "FADD", "FMUL", "LDS", "STS", "BRA")


def sass_counts(so_path: Path, kernel: str):
    """Instructions in the SASS of ``kernel``'s instantiations in the
    library at ``so_path``: the total, the opcodes of SASS_OPS (any
    suffix) and IMAD.HI / IMAD.SHL / IMAD.MOV apart (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([cuobjdump, "-sass", str(so_path)], capture_output=True, text=True)
    out, inside = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            inside = name if kernel in name and "tables" not in name else None
            continue
        if not inside or "*/" not in line:
            continue
        toks = line.split("*/", 1)[1].split()
        op = toks[1] if len(toks) > 1 and toks[0].startswith("@") else (toks[0] if toks else "")
        if not op or op.startswith("/*"):
            continue
        counts = out.setdefault(inside, {"total": 0})
        counts["total"] += 1
        for key in {op.split(".")[0], ".".join(op.split(".")[:2])}:
            if key in SASS_OPS or key in ("IMAD.HI", "IMAD.SHL", "IMAD.MOV"):
                counts[key] = counts.get(key, 0) + 1
    return out or {"cuobjdump": res.stderr.strip()[:400]}


def pow2_route(torch, ck, _build, volumes):
    """ms of the FFT kernel as built and with its power-of-two route taken
    out (NO_POW2_ROUTE: the plan then carries the divisors, 8 ZY_DIVS
    bytes more), in turns (whole, without, without, whole; CUDA events,
    20 warm calls each), the two results compared bit for bit, and each
    build's SASS counts."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, edits in (("whole", []), ("no power-of-two route", NO_POW2_ROUTE)):
            work = Path(tmp) / str(len(libs))
            work.mkdir()
            libs[name] = build_variant(_build.find_nvcc(), flags, edits, work)
            out[f"sass {name}"] = sass_counts(work / "k.so", "zy_fft_kernel")
            print(f"sass {name}: {json.dumps(out[f'sass {name}'])}", flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        for vname, x in volumes:
            plan = ck._zy_fft_plan(int(x.shape[1]), int(x.shape[2]))
            runs = {}
            for name, so in libs.items():
                p = plan if name == "whole" else dataclasses.replace(plan, smem=plan.smem + 8 * ck.ZY_DIVS)
                ints = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
                nbytes = so.fava_zy_fft_table_bytes(ctypes.addressof(ints))
                if nbytes < 0:
                    sys.exit(f"{name}: the plan does not hold: {p}")
                tables = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
                if so.fava_zy_fft_tables(ctypes.addressof(ints), tables.data_ptr(), stream):
                    sys.exit(f"{name}: tables failed")
                re, im = ck._zy_outputs(x)

                def run(so=so, ints=ints, tables=tables, re=re, im=im, name=name):
                    if so.fava_zy_fft(x.data_ptr(), re.data_ptr(), im.data_ptr(), tables.data_ptr(),
                                      int(x.shape[0]), ctypes.addressof(ints), 1, stream):
                        sys.exit(f"{name}: launch error")

                runs[name] = (run, re, im, tables)
            names = list(runs)
            t = {f"{n} {i}": cuda_ms(torch, runs[n][0], 20) for i, n in ((1, names[0]), (1, names[1]))}
            t.update({f"{n} {i}": cuda_ms(torch, runs[n][0], 20) for i, n in ((2, names[1]), (2, names[0]))})
            (_, re0, im0, _), (_, re1, im1, _) = runs.values()
            t["bit_equal"] = bool(torch.equal(re0, re1) and torch.equal(im0, im1))
            out[vname] = t
            print(f"power-of-two route {vname}: {json.dumps(t)}", flush=True)
            del runs
            torch.cuda.empty_cache()
    return out


def radix_plan(ck, ny: int, nz: int, radices):
    """The plan _zy_fft_plan makes when the kernel's register DFTs are
    ``radices``."""
    kept = ck.ZY_RADICES
    ck.ZY_RADICES = tuple(radices)
    ck._radices.cache_clear()
    try:
        return ck._zy_fft_plan.__wrapped__(ny, nz)
    finally:
        ck.ZY_RADICES = kept
        ck._radices.cache_clear()


def radix_sets(torch, ck, volumes):
    """ms of the FFT kernel under its plan, under the plan with only
    BASE_RADICES, and under the plan without each composite radix that its
    plan uses, in turns (each in order, then in reverse; CUDA events, 20
    warm calls each), with each plan's radices and its error against the
    plan's result (same function, other rounding)."""
    out = {}
    for vname, x in volumes:
        ny, nz = int(x.shape[1]), int(x.shape[2])
        plan = ck._zy_fft_plan(ny, nz)
        plans = {"plan": plan, "base radices": radix_plan(ck, ny, nz, BASE_RADICES)}
        for r in sorted(set(plan.radices_z + plan.radices_y) - set(BASE_RADICES)):
            plans[f"without {r}"] = radix_plan(ck, ny, nz, [q for q in ck.ZY_RADICES if q != r])
        ref = ck._zy_rfft_fft(x, plan)
        t = {n: {"radices": [list(p.radices_z), list(p.radices_y)], "cluster": p.cluster, "batch": p.batch,
                 "active_clusters": ck.zy_fft_active_clusters(p), "err": rel_err(ck._zy_rfft_fft(x, p), ref)}
             for n, p in plans.items()}
        order = list(plans)
        for n in order + order[::-1]:
            t[n].setdefault("ms", []).append(cuda_ms(torch, lambda p=plans[n]: ck._zy_rfft_fft(x, p), 20))
        out[vname] = t
        print(f"radix sets {vname}: {json.dumps(t)}", flush=True)
        del ref
        torch.cuda.empty_cache()
    return out


def main() -> None:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from fava_tpu_torch import flagship
    from fava_tpu_torch.ops import _build
    from fava_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    entry = False
    for line in (_build.BUILD_LOG or "").splitlines():
        if "Compiling entry" in line:
            entry = "zy_fft_kernel" in line
        if entry:
            print(f"ptxas: {line.strip()}", flush=True)
    out = {"card": card, "checks": {}, "times": {}}
    if "--chirp" in sys.argv or "--parent" in sys.argv:
        f = flagship.make_example_fields(512)
        x = (torch.sqrt(f[0]) * f[1]).contiguous()
        del f
        if "--chirp" in sys.argv:
            out["chirp_plans"] = chirp_plans(torch, ck, [
                ("512x512x502", x[..., :502].contiguous()), ("512x502x512", x[:, :502].contiguous()),
                ("512x509x509", x[:, :509, :509].contiguous()), ("512x512x1", x[..., :1].contiguous()),
                ("512x509x1", x[:, :509, :1].contiguous())])
        else:
            gen = torch.Generator(device="cuda").manual_seed(0)
            out["parent"] = against_parent(torch, ck, _build, Path(sys.argv[sys.argv.index("--parent") + 1]), [
                ("512^3", x), ("512x512x480", x[..., :480].contiguous()),
                ("512x480x512", x[:, :480].contiguous()), ("512x384x375", x[:, :384, :375].contiguous()),
                ("512x512x502", x[..., :502].contiguous()), ("512x502x512", x[:, :502].contiguous()),
                ("512x509x509", x[:, :509, :509].contiguous()), ("512x512x1", x[..., :1].contiguous()),
                ("(8, 1024, 1024)", torch.randn((8, 1024, 1024), generator=gen, device="cuda"))])
        print(json.dumps(out), flush=True)
        return
    if "--phases" in sys.argv or "--timeline" in sys.argv or "--variants" in sys.argv:
        f = flagship.make_example_fields(512)
        x = (torch.sqrt(f[0]) * f[1]).contiguous()
        del f
        volumes = [("512^3", x), ("512x512x480", x[..., :480].contiguous()),
                   ("512x384x375", x[:, :384, :375].contiguous())]
        if "--variants" not in sys.argv:
            out["timeline"] = {name: timeline(torch, ck, _build, v) for name, v in volumes}
        if "--timeline" not in sys.argv:
            out["phase_ms"] = phase_times(torch, ck, _build, volumes)
        print(json.dumps(out), flush=True)
        return
    if "--designs" in sys.argv:
        f = flagship.make_example_fields(512)
        x = (torch.sqrt(f[0]) * f[1]).contiguous()
        del f
        gen = torch.Generator(device="cuda").manual_seed(0)
        x1024 = torch.randn((8, 1024, 1024), generator=gen, device="cuda")
        out["power_of_two_route"] = pow2_route(torch, ck, _build, [("512^3", x), ("(8, 1024, 1024)", x1024)])
        del x1024
        cuts = [("512x512x480", x[..., :480].contiguous()), ("512x480x512", x[:, :480].contiguous()),
                ("512x384x375", x[:, :384, :375].contiguous()), ("512x384x384", x[:, :384, :384].contiguous())]
        d = cuts[0][1]
        out["times"]["512x512x480"] = t = {
            "route": cuda_ms(torch, lambda: ck.zy_rfft_planar(d), 20),
            "dense": cuda_ms(torch, lambda: ck._zy_rfft_dense(d), 3),
            "rfftn": cuda_ms(torch, lambda: torch.fft.rfftn(d, dim=(1, 2)), 20)}
        print(f"times 512x512x480 (ms): {json.dumps(t)}", flush=True)
        out["radix_sets"] = radix_sets(torch, ck, cuts)
        del x, cuts, d
        torch.cuda.empty_cache()
        wide = [(nx, n) for nx, n in ((256, 576), (256, 640), (256, 768), (128, 896))]
        out["radix_sets"].update(radix_sets(torch, ck, [
            (f"{nx}x{n}x{n}", torch.randn((nx, n, n), generator=gen, device="cuda")) for nx, n in wide]))
        print(json.dumps(out), flush=True)
        return
    ok = True
    rng = np.random.default_rng(0)
    for shape in SMALL:
        x = torch.from_numpy(rng.standard_normal(shape)).float().cuda()
        ck.reset_launch_counts()
        got = ck.zy_rfft_planar(x)
        torch.cuda.synchronize()
        e = rel_err(got, ck._zy_rfft_plain(x.double()))
        twin = rel_err(got, ck._zy_rfft_fft_plain(x, ck._zy_fft_plan(shape[1], shape[2])))
        launched = ck.launch_counts()["zy_rfft_planar"] == 1
        out["checks"][str(shape)] = {"err": e, "vs_f32_twin": twin, "launched": launched}
        print(f"check {shape}: error {e!r} of the largest coefficient, vs the f32 FFT twin {twin!r}, "
              f"launched {launched}", flush=True)
        ok &= e <= TOL_ZY and twin <= 1e-6 and launched
    fields = flagship.make_example_fields(512)
    x512 = (torch.sqrt(fields[0]) * fields[1]).contiguous()
    del fields
    x1024 = torch.from_numpy(rng.standard_normal((8, 1024, 1024))).float().cuda()
    volumes = [("512^3", x512), ("512x512x480", x512[..., :480].contiguous()),
               ("512x480x512", x512[:, :480].contiguous()), ("512x384x375", x512[:, :384, :375].contiguous()),
               ("(8, 1024, 1024)", x1024), ("512x512x502", x512[..., :502].contiguous()),
               ("512x502x512", x512[:, :502].contiguous()), ("512x509x509", x512[:, :509, :509].contiguous()),
               ("512x512x1", x512[..., :1].contiguous())]
    for name, x in volumes:
        ck.reset_launch_counts()
        got = ck.zy_rfft_planar(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        ref = ck._zy_rfft_plain(x.double())
        e = rel_err(got, ref)
        dense = rel_err(ck._zy_rfft_dense(x), ref) if name in ("512^3", "512x512x502") else None
        del ref, got
        entry = {"err": e, "dense_err": dense, "launches": counts}
        plan = ck._zy_fft_plan(x.shape[1], x.shape[2])
        entry.update(plan=plan.as_ints(), active_clusters=ck.zy_fft_active_clusters(plan))
        print(f"check {name}: plan {plan}; active clusters {entry['active_clusters']}", flush=True)
        out["checks"][name] = entry
        print(f"check {name}: error {e!r} (dense kernel {dense!r}); launches {counts}", flush=True)
        ok &= e <= TOL_ZY and counts == {"zy_rfft_planar": 1}
        torch.cuda.empty_cache()
    print(json.dumps({"checks_ok": bool(ok)}), flush=True)
    if "--quick" not in sys.argv:
        for name, x in volumes:
            ny, nz = int(x.shape[1]), int(x.shape[2])
            t = {"route": cuda_ms(torch, lambda: ck.zy_rfft_planar(x), 20),
                 "rfftn": cuda_ms(torch, lambda: torch.fft.rfftn(x, dim=(1, 2)), 20)}
            if name in ("512^3", "512x512x480", "512x512x502"):
                t["dense"] = cuda_ms(torch, lambda: ck._zy_rfft_dense(x), 3)
            chirp = ck._zy_fft_plan(ny, nz).chirp_z or ck._zy_fft_plan(ny, nz).chirp_y
            for passes in (1, 2, 4):
                for cluster in (16, 8, 4, 2):
                    for budget in ("half", "full"):
                        for home in ("shared", "global") if chirp else ("shared",):
                            plan = ck._fit_plan(ny, nz, cluster, passes,
                                                ck.ZY_SMEM_HALF if budget == "half" else ck.ZY_SMEM_MAX,
                                                home == "global")
                            if plan is None or passes > plan.nslot or ck.zy_fft_active_clusters(plan) < 1:
                                continue
                            key = f"C{cluster} P{passes} {budget} {home} tile{plan.tile} batch{plan.batch}"
                            t[key] = cuda_ms(torch, lambda: ck._zy_rfft_fft(x, plan), 20)
            if chirp:
                t.update(chirp_lengths(torch, ck, x))
            out["times"][name] = t
            print(f"times {name} (ms): {json.dumps(t)}", flush=True)
    print(json.dumps(out), flush=True)
    if not ok:
        sys.exit("the FFT kernel disagrees with the dense DFT")


def chirp_plans(torch, ck, volumes):
    """ms of the kernel on each chirp volume under its plan and under the
    plans of 1 and 2 passes, both budgets, both homes of the chirp tables
    and clusters of 16 and 8, each at the row batches that fit (up to 10
    of them), with whether the result is bit-equal to the plan's."""
    out = {}
    for vname, x in volumes:
        ny, nz = int(x.shape[1]), int(x.shape[2])
        plan = ck._zy_fft_plan(ny, nz)
        ref = ck._zy_rfft_fft(x, plan)
        t = {"plan": [dataclasses.asdict(plan), cuda_ms(torch, lambda: ck._zy_rfft_fft(x, plan), 20)]}
        for passes in (1, 2):
            for budget in ("half", "full"):
                for home in ("shared", "global"):
                    for cluster in (16, 8, 4, 2, 1) if nz == 1 else (16, 8):
                        limit = ck.ZY_SMEM_HALF if budget == "half" else ck.ZY_SMEM_MAX
                        base = ck._fit_plan(ny, nz, cluster, passes, limit, home == "global")
                        if base is None or passes > base.nslot:
                            continue
                        room = limit - (base.smem - 8 * base.work)
                        most = min(room // (8 * base.ws), -(-base.rows // 2) if base.odd else base.rows)
                        seqs = sorted({q for q in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, most) if q <= most})
                        for q in seqs[-(4 if nz == 1 else 10):]:
                            p = dataclasses.replace(base, batch=2 * q if base.odd else q, work=q * base.ws,
                                                    smem=base.smem - 8 * base.work + 8 * q * base.ws)
                            if ck.zy_fft_active_clusters(p) < 1:
                                continue
                            got = ck._zy_rfft_fft(x, p)
                            same = bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
                            key = f"C{cluster} P{passes} {budget} {home} batch{p.batch} smem{p.smem}"
                            t[key] = [cuda_ms(torch, lambda: ck._zy_rfft_fft(x, p), 20), same]
        out[vname] = t
        print(f"chirp plans {vname}: {json.dumps(t)}", flush=True)
        torch.cuda.empty_cache()
    return out


# A build whose kernel finds its table bytes at run time, as the parent's did.
RUNTIME_TABLE_BYTES = [("const int hb = table_bytes<Mode>(p),",
                        "const int hb = Chirp ? table_bytes<kChirp>(p) : zy_mode(p) == kPow2 ? "
                        "table_bytes<kPow2>(p) : table_bytes<kMixed>(p),")]


def against_parent(torch, ck, _build, parent: Path, volumes):
    """ms of the kernel as built and of the parent checkout's build under
    the same plan (the first 33 ints of the plan vector are the parent's
    struct), in turns: this, parent, parent, this (CUDA events, 20 warm
    calls each), the two results compared bit for bit; the SASS counts of
    both builds; then the same against the build RUNTIME_TABLE_BYTES."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out = {"sass this": sass_counts(_build.build(), "zy_fft_kernel")}
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "p").mkdir()
        (Path(tmp) / "v").mkdir()
        with ThreadPoolExecutor(2) as pool:  # the two builds at once
            so = pool.submit(build_variant, _build.find_nvcc(), flags, [], Path(tmp) / "p", parent)
            variant = pool.submit(build_variant, _build.find_nvcc(), flags, RUNTIME_TABLE_BYTES,
                                  Path(tmp) / "v")
            so, variant = so.result(), variant.result()
        out["sass parent"] = sass_counts(Path(tmp) / "p" / "k.so", "zy_fft_kernel")
        out["sass runtime table bytes"] = sass_counts(Path(tmp) / "v" / "k.so", "zy_fft_kernel")
        for k in ("sass this", "sass parent", "sass runtime table bytes"):
            print(f"{k}: {json.dumps(out[k])}", flush=True)
        for vname, x in volumes:
            plan = ck._zy_fft_plan(int(x.shape[1]), int(x.shape[2]))
            ints = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
            nbytes = so.fava_zy_fft_table_bytes(ctypes.addressof(ints))
            tables = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
            if nbytes < 0 or so.fava_zy_fft_tables(ctypes.addressof(ints), tables.data_ptr(), stream):
                sys.exit(f"parent build refuses the plan {plan}")
            re, im = ck._zy_outputs(x)

            def parent_run():
                if so.fava_zy_fft(x.data_ptr(), re.data_ptr(), im.data_ptr(), tables.data_ptr(), int(x.shape[0]),
                                  ctypes.addressof(ints), 1, stream):
                    sys.exit("parent build: launch error")

            def this_run():
                return ck._zy_rfft_fft(x, plan)

            vre, vim = ck._zy_outputs(x)

            def variant_run():
                if variant.fava_zy_fft(x.data_ptr(), vre.data_ptr(), vim.data_ptr(), tables.data_ptr(),
                                       int(x.shape[0]), ctypes.addressof(ints), 1, stream):
                    sys.exit("variant build: launch error")

            t = [cuda_ms(torch, f, 20) for f in (this_run, parent_run, variant_run, variant_run, parent_run,
                                                 this_run)]
            got = this_run()
            parent_run()
            variant_run()
            torch.cuda.synchronize()
            same = bool(torch.equal(got[0], re) and torch.equal(got[1], im) and torch.equal(vre, re))
            out[vname] = {"this_ms": [t[0], t[5]], "parent_ms": [t[1], t[4]], "runtime_table_bytes_ms": t[2:4],
                          "bit_equal": same}
            print(f"against parent {vname}: {json.dumps(out[vname])}", flush=True)
            del tables, re, im, got
            torch.cuda.empty_cache()
    return out


def chirp_lengths(torch, ck, x):
    """ms of the kernel under the plan the rule makes when a chirp axis of
    ``x`` is transformed at each 7-smooth length M from 2n - 1 up to the
    power of two above (the fewest passes' two smallest and the power of
    two), with its error against the plan's result."""
    ny, nz = int(x.shape[1]), int(x.shape[2])
    plan = ck._zy_fft_plan(ny, nz)
    kept = ck._chirp_length
    out = {}
    for n, axis in ((plan.nt, "z"), (ny, "y")):
        if ck._smooth7(n):
            continue
        lo = 2 * n - 1
        p2 = 1 << (lo - 1).bit_length()
        cands = sorted((k for k in range(lo, p2 + 1) if ck._smooth7(k)), key=lambda k: (len(ck._radices(k)), k))
        for m in sorted(set(cands[:2] + [p2])):
            ck._chirp_length = lambda k, n=n, m=m: m if k == n else kept(k)
            try:
                alt = ck._zy_fft_plan.__wrapped__(ny, nz)
            finally:
                ck._chirp_length = kept
            err = rel_err(ck._zy_rfft_fft(x, alt), ck._zy_rfft_fft(x, plan))
            out[f"{axis} M={m} {ck._radices(m)} C{alt.cluster} P{alt.passes} batch{alt.batch} err {err:.2e}"] = \
                cuda_ms(torch, lambda: ck._zy_rfft_fft(x, alt), 20)
    return out


if __name__ == "__main__":
    main()
