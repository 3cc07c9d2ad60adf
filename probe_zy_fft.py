#!/usr/bin/env python3
"""Probe of B12's cluster FFT kernel on one NVIDIA GPU.

Run from the repository root:

    python3 probe_zy_fft.py [--quick]

It builds the kernels, prints the FFT kernel's ptxas report, holds the
kernel to the float64 dense DFT (``_zy_rfft_plain``) on small shapes, on
sqrt(rho)*v_x of ``make_example_fields(512)`` and on an (8, 1024, 1024)
random volume (the two-pass plan), within 1e-5 of the largest coefficient;
then times (CUDA events, warm) the kernel under its plan and under other
cluster sizes, passes and shared-memory budgets, beside the dense kernel
and ``torch.fft.rfftn(x, dim=(1, 2))``. ``--quick`` stops after the checks.
``--phases`` instead times, at 512^3, builds of the kernel with one phase
taken out of the source (their results are wrong; only their times count),
to show where the kernel's time goes, after a build that sums each phase's
and each pass's clock64() cycles over the blocks (``--timeline``: that
build alone; ``--variants``: the other whole builds alone). Its last line
is all its results as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
TOL_ZY = 1e-5
SMALL = [(2, 2, 2), (3, 64, 32), (1, 1024, 2), (2, 1, 8), (2, 16, 2), (1, 2, 2), (2, 8, 1024),
         (4, 1024, 8), (2, 512, 512)]


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


# Text edits of csrc/dft_kernels.cu that take one phase out of the FFT kernel.
LOAD = "return vec ? __ldg(reinterpret_cast<const float2*>(q)) : make_float2(__ldg(q), __ldg(q + 1));"
REMOTE = "cluster.map_shared_rank(cols, u - pass * c)"
ARRIVE = 'asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");'
WAIT = 'asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");'
CUTS = {
    "z transform": [("fft_run(rows_in, rows_mid, rows_mid, ln, lz, p.nlz, lbatch, p.batch, twpz);", "")],
    "post-process": [("e < p.batch * wp;", "e < 0;")],
    "y transform": [("fft_run(cols_mid, cols_mid, cols_out, lny, ly, p.nly, log2i(tw), tw, twpy);", "")],
    "output stores": [("re[o] = v.x;\n    im[o] = v.y;", "")],
    "DSMEM (local stores)": [(REMOTE, "cols")],
    "DSMEM and cluster barriers": [(REMOTE, "cols"), ('asm volatile("barrier.cluster', '// ('),
                                   ("  cluster.sync();\n", "  __syncthreads();\n")],
    "global loads": [(LOAD, "return make_float2((float)s, (float)e);")],
    "global loads and stores": [(LOAD, "return make_float2((float)s, (float)e);"),
                                ("re[o] = v.x;\n    im[o] = v.y;", "")],
}
# Other builds of the whole kernel, timed beside it.
VARIANTS = {
    "512 threads": [("constexpr int kFftThreads = 256;", "constexpr int kFftThreads = 512;"),
                    ("__launch_bounds__(kFftThreads, 2)\nzy_fft_kernel(",
                     "__launch_bounds__(kFftThreads)\nzy_fft_kernel(")],
    "no minimum of two blocks an SM": [("__launch_bounds__(kFftThreads, 2)\nzy_fft_kernel(",
                                        "__launch_bounds__(kFftThreads)\nzy_fft_kernel(")],
    "streaming stores": [("re[o] = v.x;\n    im[o] = v.y;", "__stcs(re + o, v.x);\n    __stcs(im + o, v.y);")],
    "streaming loads": [("__ldg(reinterpret_cast<const float2*>(q))", "__ldcs(reinterpret_cast<const float2*>(q))")],
}


# Text edits that make each block add its phases' clock64() spans to a
# device array (cycles summed over blocks); fava_zy_timeline copies it out.
SPANS = ("tables", "z transforms", "post-process", "barrier", "y transforms")
PASS_SPANS = tuple(f"{axis} pass {i}" for axis in "zy" for i in range(4))
TIMELINE = [
    ("// A 2^ln-point transform of nseq sequences",
     "__device__ unsigned long long zy_timeline[16];\n// A 2^ln-point transform of nseq sequences"),
    ("  int lL = ln;\n  for (int i = 0; i < nst; ++i) {\n",
     "  int lL = ln;\n  for (int i = 0; i < nst; ++i) {\n    const long long tp_ = clock64();\n"),
    ("    lL -= logs[i];\n    __syncthreads();\n",
     "    lL -= logs[i];\n    __syncthreads();\n    if (threadIdx.x == 0) atomicAdd(&zy_timeline[(sizeof(Src) == "
     "sizeof(SlabRows) ? 8 : 12) + i], (unsigned long long)(clock64() - tp_));\n"),
    ("  const int zpad = ln - (p.nlz ? p.lz[0] : 0);  // see zy_fft_tables_kernel\n",
     "  const int zpad = ln - (p.nlz ? p.lz[0] : 0);\n  long long tk[8] = {}; long long t_ = clock64();\n"),
    ("  // Phase 1: this rank's rows", "  tk[0] += clock64() - t_; t_ = clock64(); tk[7] = 1;\n  // Phase 1: this rank's rows"),
    ("p.batch, twpz);\n", "p.batch, twpz);\n    tk[1] += clock64() - t_; t_ = clock64();\n"),
    ("    __syncthreads();\n  }\n  // Every rank's stores",
     "    __syncthreads();\n    tk[2] += clock64() - t_; t_ = clock64();\n  }\n  // Every rank's stores"),
    ("  cluster.sync();\n\n  // Phase 2", "  cluster.sync();\n  tk[3] += clock64() - t_; t_ = clock64();\n\n  // Phase 2"),
    ("\n}\n\nbool pow2(int n)",
     "\n  tk[4] += clock64() - t_;\n  if (threadIdx.x == 0) { for (int i = 0; i < 5; ++i) atomicAdd(&zy_timeline[i], "
     "(unsigned long long)tk[i]); atomicAdd(&zy_timeline[6], 1ull); atomicAdd(&zy_timeline[7], "
     "(unsigned long long)tk[7]); }\n}\n\nbool pow2(int n)"),
    ('}  // extern "C"', 'int fava_zy_timeline(void* out) { return (int)cudaMemcpyFromSymbol(out, zy_timeline, '
     '16 * sizeof(unsigned long long)); }\n}  // extern "C"'),
]


def build_variant(nvcc, flags, edits, work: Path):
    """The dft kernels' library with ``edits`` applied to the source."""
    src = (HERE / "fava_tpu_torch" / "csrc" / "dft_kernels.cu").read_text()
    for old, new in edits:
        if old not in src:
            sys.exit(f"edit target not found: {old!r}")
        src = src.replace(old, new)
    for h in (HERE / "fava_tpu_torch" / "csrc").glob("*.cuh"):
        shutil.copy(h, work / h.name)
    (work / "k.cu").write_text(src)
    lib = work / "k.so"
    subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(work / "k.cu")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.fava_zy_fft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                                      ctypes.c_void_p]
    so.fava_zy_fft.restype = ctypes.c_int
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


def phase_times(torch, ck, _build, x):
    """ms of the FFT kernel with each phase cut, and whole."""
    ny, nz = int(x.shape[1]), int(x.shape[2])
    plan = ck._zy_fft_plan(ny, nz)
    ints = (ctypes.c_int * len(plan.as_ints()))(*plan.as_ints())
    re, im = ck._zy_outputs(x)
    tables = ck._zy_fft_tables(plan, str(x.device)).data_ptr()
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cuts = {} if "--variants" in sys.argv else {f"without {k}": v for k, v in CUTS.items()}
        variants = {"whole": [], **cuts, **VARIANTS}
        for i, (name, edits) in enumerate(variants.items()):
            work = Path(tmp) / str(i)
            work.mkdir()
            so = build_variant(nvcc, flags, edits, work)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = so.fava_zy_fft(x.data_ptr(), re.data_ptr(), im.data_ptr(), tables, int(x.shape[0]),
                                     ctypes.addressof(ints), 1, stream)
                if err:
                    sys.exit(f"{name}: launch error {err}")

            out[name] = cuda_ms(torch, run, 20)
            print(f"phase cut {name}: {out[name]!r} ms", flush=True)
    return out


def rel_err(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    return err / scale


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
    if "--phases" in sys.argv or "--timeline" in sys.argv or "--variants" in sys.argv:
        f = flagship.make_example_fields(512)
        x = (torch.sqrt(f[0]) * f[1]).contiguous()
        if "--variants" not in sys.argv:
            out["timeline"] = timeline(torch, ck, _build, x)
        if "--timeline" not in sys.argv:
            out["phase_ms"] = phase_times(torch, ck, _build, x)
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
        ok &= e <= TOL_ZY and launched
    fields = flagship.make_example_fields(512)
    x512 = (torch.sqrt(fields[0]) * fields[1]).contiguous()
    del fields
    x1024 = torch.from_numpy(rng.standard_normal((8, 1024, 1024))).float().cuda()
    for name, x in (("sqrt(rho) v_x 512^3", x512), ("random (8, 1024, 1024)", x1024)):
        plan = ck._zy_fft_plan(x.shape[1], x.shape[2])
        got = ck.zy_rfft_planar(x)
        torch.cuda.synchronize()
        ref = ck._zy_rfft_plain(x.double())
        e = rel_err(got, ref)
        dense = rel_err(ck._zy_rfft_dense(x), ref)
        del ref
        clusters = ck.zy_fft_active_clusters(plan)
        out["checks"][name] = {"err": e, "dense_err": dense, "plan": plan.as_ints(),
                               "active_clusters": clusters}
        print(f"check {name}: error {e!r} (dense kernel {dense!r}); plan {plan}; active clusters "
              f"{clusters}", flush=True)
        ok &= e <= TOL_ZY
        torch.cuda.empty_cache()
    print(json.dumps({"checks_ok": bool(ok)}), flush=True)
    if "--quick" not in sys.argv:
        for name, x in (("512^3", x512), ("(8, 1024, 1024)", x1024)):
            ny, nz = int(x.shape[1]), int(x.shape[2])
            t = {"plan": cuda_ms(torch, lambda: ck.zy_rfft_planar(x), 20),
                 "dense": cuda_ms(torch, lambda: ck._zy_rfft_dense(x), 3),
                 "rfftn": cuda_ms(torch, lambda: torch.fft.rfftn(x, dim=(1, 2)), 20)}
            for passes in (1, 2, 4):
                for cluster in (16, 8, 4, 2):
                    for budget in ("half", "full"):
                        plan = ck._fit_plan(ny, nz, cluster, passes,
                                            ck.ZY_SMEM_HALF if budget == "half" else ck.ZY_SMEM_MAX)
                        if plan is None or ck.zy_fft_active_clusters(plan) < 1:
                            continue
                        key = f"C{cluster} P{passes} {budget} tile{plan.tile} batch{plan.batch}"
                        t[key] = cuda_ms(torch, lambda: ck._zy_rfft_fft(x, plan), 20)
            out["times"][name] = t
            print(f"times {name} (ms): {json.dumps(t)}", flush=True)
    print(json.dumps(out), flush=True)
    if not ok:
        sys.exit("the FFT kernel disagrees with the dense DFT")


if __name__ == "__main__":
    main()
