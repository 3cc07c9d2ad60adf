#!/usr/bin/env python3
"""Probe of the shell-binning walk (B6/B10, the folded K4/B4/B11a/B11b and
the fused powers binning B9) and the AMR regrid (K7) on one NVIDIA GPU.

Run from the repository root:

    python3 probe_bin_regrid.py [--quick] [--old DIR] [--bin | --walk | --regrid]

It builds the kernels, prints each kernel's ptxas report, the atomics its
SASS holds (cuobjdump) and its launch configuration, then holds B6/B10 to
its plain twin (``_shell_bin_unfolded_plain``) within 1e-9 relative per
shell on small shapes and at the path's shapes: (128, 1024, 513) chunks of
a 1024^3 half-spectrum at kx0 = 0, 448, 896, their 8 chunks against the
whole volume, and 511 x 512 x 257 (random positive powers). Then it times
(CUDA events, warm) the kernel beside builds of it with other constants or
with a part cut out (WALK_VARIANTS: their results are wrong; only their
times count), other grid sizes, and the kernel of the source tree ``DIR``
(a checkout of an earlier commit), each against its bound. The folded
kernels and B9 (``--walk``) the same way at chip_smoke.py's 512^3 shapes:
K4, B4, B11a and B11b on (257, 257, 257) folds and (257, 264, 257) pad8
folds with NaN pad rows, B9 on a (3, 512, 512, 257) complex64 stack read
in place and on planar stacks, each held to its twin (counts exactly),
then timed through its C entry beside the cut-out builds
(WALK_VARIANTS, FUSED_VARIANTS), other grids and DIR's kernels, and
through its wrapper (device time of 20 calls, and host time a call). K7
the same way: bit-exact against ``_regrid_plain`` on small plans (odd nz, window
origins off a multiple of 4, 1/4/8 fields, scale 1 only, holes) and on
chip_smoke.py's rtflame-like tree (random stacks): the 2048x512x512
full-domain regrid of one field and the 512^3 window of four, then timed
through its wrapper and its C entry at other block shapes and grids,
beside builds with a part cut out (REGRID_VARIANTS), a library write and
copy of the same bytes, and the kernel of ``DIR``. ``--bin`` /
``--walk`` / ``--regrid`` run one part only; ``--quick`` stops after the
checks. Its last line is all its results as one JSON object.
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
CSRC = HERE / "fava_tpu_torch" / "csrc"
TOL_BIN = 1e-9
HBM_BYTES_PER_S = 3.35e12
# (nx, ny, nz, full grid, channels): odd, tiny, a single row, full grids.
SMALL = [(3, 5, 7, False, 2), (31, 1, 16, False, 1), (9, 9, 9, False, 2), (7, 6, 5, True, 2),
         (8, 8, 8, True, 1), (33, 17, 64, False, 2), (64, 64, 1024, False, 2), (5, 7, 2, False, 2)]

# Text edits (file, old, new) of the walk, csrc/shell_bins.cuh, that every
# walk kernel shares: other constants, and cuts.
WALK = "shell_bins.cuh"
WALK_VARIANTS = {
    "groups 1": [(WALK, "constexpr int kMaxGroups = 2;", "constexpr int kMaxGroups = 1;")],
    "groups 4": [(WALK, "constexpr int kMaxGroups = 2;", "constexpr int kMaxGroups = 4;")],
    "launch bounds (256, 4)": [(WALK, "__launch_bounds__(kBinMaxWarps * 32)\nshell_walk_kernel",
                                "__launch_bounds__(kBinMaxWarps * 32, 4)\nshell_walk_kernel")],
    "launch bounds (256, 5)": [(WALK, "__launch_bounds__(kBinMaxWarps * 32)\nshell_walk_kernel",
                                "__launch_bounds__(kBinMaxWarps * 32, 5)\nshell_walk_kernel")],
    "launch bounds (256, 6)": [(WALK, "__launch_bounds__(kBinMaxWarps * 32)\nshell_walk_kernel",
                                "__launch_bounds__(kBinMaxWarps * 32, 6)\nshell_walk_kernel")],
    "launch bounds (256, 8)": [(WALK, "__launch_bounds__(kBinMaxWarps * 32)\nshell_walk_kernel",
                                "__launch_bounds__(kBinMaxWarps * 32, 8)\nshell_walk_kernel")],
    "warps 16, launch bounds (512, 3)": [
        (WALK, "constexpr int kBinMaxWarps = 8;", "constexpr int kBinMaxWarps = 16;"),
        (WALK, "__launch_bounds__(kBinMaxWarps * 32)\nshell_walk_kernel",
         "__launch_bounds__(kBinMaxWarps * 32, 3)\nshell_walk_kernel")],
    "warps 4": [(WALK, "constexpr int kBinMaxWarps = 8;", "constexpr int kBinMaxWarps = 4;")],
    "warps 16": [(WALK, "constexpr int kBinMaxWarps = 8;", "constexpr int kBinMaxWarps = 16;")],
    "walk setup only": [(WALK, "    if (w.len == 0) continue;\n",
                         "    if (w.len == 0) continue;\n    if (w.len != -5) continue;\n")],
    "without the binning": [(WALK, "          if (g < m) bin_group<CV, kCounts>(a[g], p0 + 4 * g, w, bw, z_nyq, rw.mxy, thr, hist, r);\n",
                             "          if (g < m) r.acc[0] += (double)(a[g][0].x + a[g][0].w + a[g][CV - 1].x);\n")],
    "without the span-end scan": [(WALK, "      add_span_ends<CO>(r, hist, nbins, lane);\n",
                                   "      if (r.cur < nbins) hist.add(r.cur, r.acc);\n")],
    "without the run adds": [(WALK, "      hist.add(cur, acc);\n", "")],
    "without run ends": [(WALK, "    if (k2 >= next) {\n", "    if (false) {\n")],
    "without loads": [(WALK, "? __ldg(reinterpret_cast<const float4*>(w.row[c] - w.head + q))",
                       "? make_float4(1.f, 1.f, 1.f, 1.f)")],
    "without the global flush": [(WALK, "    if (s != 0.0) atomicAdd(", "    if (s == -1.0) atomicAdd(")],
    "smem attribute at the card's maximum": [
        (WALK, "  if (smem <= 48 * 1024) return cudaSuccess;\n", ""),
        (WALK, "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);",
         "cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());")],
    "folded rows i-major": [(WALK, """    const unsigned j = (unsigned)idx / (unsigned)nxh;""",
                             """    const unsigned j = (unsigned)idx % (unsigned)rows;"""),
                            (WALK, """    const int i = (int)((unsigned)idx - j * (unsigned)nxh);""",
                             """    const int i = (int)((unsigned)idx / (unsigned)rows);""")],
}
# Text edits of csrc/fused_spectra_kernels.cu (B9): its span and register
# budget, and cuts.
FUSED = "fused_spectra_kernels.cu"
FUSED_VARIANTS = {
    "span 4, 1 block an SM": [(FUSED, "kSpan = kInterleaved ? 2 : 4;", "kSpan = kInterleaved ? 4 : 4;"),
                              (FUSED, "kMinBlocks = kInterleaved ? 2 : 1;", "kMinBlocks = kInterleaved ? 1 : 1;")],
    "span 4, 2 blocks an SM": [(FUSED, "kSpan = kInterleaved ? 2 : 4;", "kSpan = kInterleaved ? 4 : 4;")],
    "span 2, 1 block an SM": [(FUSED, "kMinBlocks = kInterleaved ? 2 : 1;", "kMinBlocks = kInterleaved ? 1 : 1;")],
    "span 2, 3 blocks an SM": [(FUSED, "kMinBlocks = kInterleaved ? 2 : 1;", "kMinBlocks = kInterleaved ? 3 : 1;")],
    "warps 4": WALK_VARIANTS["warps 4"],
    "warps 16, span 2, 1 block an SM": WALK_VARIANTS["warps 16"] + [
        (FUSED, "kMinBlocks = kInterleaved ? 2 : 1;", "kMinBlocks = kInterleaved ? 1 : 1;")],
    "walk setup only": [(FUSED, "    if (len == 0) continue;\n",
                         "    if (len == 0) continue;\n    if (len != -5) continue;\n")],
    "without loads": [(FUSED, "? __ldg(reinterpret_cast<const float4*>(s.re + 2 * (o + z)))",
                       "? make_float4(1.f, 2.f, 3.f, 4.f)")],
    "without the powers": [(FUSED, "  for (int p = 0; p < 4; ++p) partner_powers(sp[p], k, pt.kx[p], pt.ky[p], kz, kz0, inv_k2, t[p], l[p]);\n",
                            "  for (int p = 0; p < 4; ++p)\n    t[p] = l[p] = (double)(sp[p].re[0][k] + sp[p].im[0][k] + sp[p].re[1][k] + "
                            "sp[p].im[1][k] + sp[p].re[2][k] + sp[p].im[2][k]);\n")],
    "without the binning": [(FUSED, "  r.add(v, wz, thr, hist);\n", "  r.acc[1] += v[1];\n  r.acc[2] += v[2];\n")],
    "without the span-end scan": [(FUSED, "      fava::add_span_ends<3>(r, hist, nbins, lane);\n",
                                   "      if (r.cur < nbins) hist.add(r.cur, r.acc);\n")],
    "without the global flush": WALK_VARIANTS["without the global flush"],
    "smem attribute at the card's maximum": WALK_VARIANTS["smem attribute at the card's maximum"],
}

# Text edits of csrc/amr_kernels.cu: cuts (their results are wrong; only
# their times count).
REGRID_VARIANTS = {
    "without source loads": [("v[i] = src[i] >= 0 ? __ldg(f.src[k] + src[i]) : 0.0f;",
                              "v[i] = src[i] >= 0 ? (float)src[i] : 0.0f;")],
    "without stores": [("*reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);",
                        "if (v[0] + v[1] + v[2] + v[3] == 12345.f) *d = 0.f;")],
    "without lookups": [("  RegridTile<ZOff<I>> r{table[tile], 0, 0, 0};\n  if (r.blk < 0) return r;\n"
                         "  r.shift = shifts[r.blk];\n  const int64_t* o = offsets + 3 * (int64_t)r.blk;\n",
                         "  RegridTile<ZOff<I>> r{(int)(tile % 4096), 0, 0, 0};\n  if (r.blk < 0) return r;\n"
                         "  r.shift = r.blk & 3;\n  const int64_t o[3] = {0, 0, 0};\n")],
}


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


def build_libs(nvcc, flags, sources, work: Path):
    """{name: CDLL} of each (source text, headers dir[, {header: text}]) in
    ``sources``, built by one nvcc each, all at once."""
    procs = {}
    for i, (name, (text, headers, *edits)) in enumerate(sources.items()):
        d = work / str(i)
        d.mkdir()
        for h in headers.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        for h, body in (edits[0] if edits else {}).items():
            (d / h).write_text(body)
        (d / "k.cu").write_text(text)
        procs[name] = (d / "k.so", subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(d / "k.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"build of {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        BUILD_LOGS[name] = log
    return libs


BUILD_LOGS = {}  # build_libs' compiler output of each library


def log_ptxas(log: str, kernel: str):
    """The registers and spills lines of ``kernel``'s entries in a ptxas log."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def edited(path: Path, edits):
    src = path.read_text()
    for old, new in edits:
        if old not in src:
            sys.exit(f"edit target not found: {old!r}")
        src = src.replace(old, new)
    return src


def variant(source: str, edits):
    """(text of csrc/``source``, CSRC, {header: text}) with the (file, old,
    new) ``edits`` applied: a build with a constant changed or a part cut."""
    texts = {source: (CSRC / source).read_text(), WALK: (CSRC / WALK).read_text()}
    for f, old, new in edits:
        if old not in texts[f]:
            sys.exit(f"edit target not found in {f}: {old!r}")
        texts[f] = texts[f].replace(old, new)
    return texts[source], CSRC, {WALK: texts[WALK]}


def sass_atomics(_build, kernel: str):
    """The shared-memory and global atomic instructions in the SASS of
    ``kernel``'s instantiations (cuobjdump -sass of the built library)."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())], capture_output=True,
                         text=True)
    out, inside = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip() if kernel in line else None
            continue
        if not inside or "*/" not in line:
            continue
        toks = line.split("*/", 1)[1].split()
        op = toks[1] if len(toks) > 1 and toks[0].startswith("@") else (toks[0] if toks else "")
        if op.startswith(("ATOM", "RED")):
            out.setdefault(inside, {}).setdefault(op, 0)
            out[inside][op] += 1
    return out or {"cuobjdump": res.stderr.strip()[:400]}


def ptxas_lines(_build, kernel: str):
    out, inside = [], False
    for line in (_build.BUILD_LOG or "").splitlines():
        if "Compiling entry" in line:
            inside = kernel in line
            if inside:
                out.append(line.strip())
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def bin_case(torch, ck, shape, full, channels, seed):
    nx, ny, nz = shape
    nzr = nz if full else nz // 2 + 1
    nbins = max(max(shape) // 2 - 1, 1)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vols = [torch.rand((nx, ny, nzr), device="cuda", generator=g) for _ in range(channels)]
    got = ck.shell_bin_sums_unfolded(vols[0], vols[1] if channels == 2 else None, nbins, nz)
    torch.cuda.synchronize()
    ref = ck._shell_bin_unfolded_plain(vols[0].double(), vols[1].double() if channels == 2 else None,
                                       nbins, nz)
    return float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())


def least_ms(nbytes):
    return 1e3 * nbytes / HBM_BYTES_PER_S


def bin_probe(torch, _build, ck, out):
    out.update({"ptxas": ptxas_lines(_build, "UnfoldedRows"),
           "sass_atomics": sass_atomics(_build, "UnfoldedRows")})
    for line in out["ptxas"]:
        print(f"ptxas: {line}", flush=True)
    print(f"SASS atomics: {json.dumps(out['sass_atomics'])}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["launch"] = {f"C{c} nbins {nb}": ck.walk_launch("fava_shell_bin_unfolded_blocks_per_sm", (c,), c,
                                                        511 * 512, nb)
                     for c, nb in ((2, 511), (2, 255), (1, 255))}
    print(f"launch: {json.dumps(out['launch'])}; SMs {sms}", flush=True)

    ok = True
    for i, (nx, ny, nz, full, channels) in enumerate(SMALL):
        r = bin_case(torch, ck, (nx, ny, nz), full, channels, i)
        out["checks"][str((nx, ny, nz, full, channels))] = r
        print(f"check {(nx, ny, nz, full, channels)}: error/bound {r!r}", flush=True)
        ok &= r <= 1.0

    n = 1024
    nzr, nbins, rows = n // 2 + 1, n // 2 - 1, 128
    g = torch.Generator(device="cuda").manual_seed(1)
    total = torch.rand((n, n, nzr), device="cuda", generator=g)
    longi = torch.rand((n, n, nzr), device="cuda", generator=g)
    for full_nx, kx0 in ((n, 0), (n, 448), (n, 896), (n - 1, 448)):
        t, lo = total[kx0 : kx0 + rows], longi[kx0 : kx0 + rows]
        got = ck.shell_bin_values_rfft_chunk(t, lo, nbins, full_nx, n, kx0)[:2]
        torch.cuda.synchronize()
        ref = ck._shell_bin_unfolded_plain(t.double(), lo.double(), nbins, n, kx0, full_nx)
        r = float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
        out["checks"][f"chunk kx0 {kx0} of {full_nx}"] = r
        print(f"check chunk {tuple(t.shape)} kx0 {kx0} of nx {full_nx}: error/bound {r!r}", flush=True)
        ok &= r <= 1.0
        del ref
    acc = sum(ck.shell_bin_values_rfft_chunk(total[k : k + rows], longi[k : k + rows], nbins, n, n, k)
              for k in range(0, n, rows))
    whole = ck.shell_bin_sums_unfolded(total, longi, nbins, n)
    r = float(((acc[:2] - whole).abs() / (TOL_BIN * whole.abs()).clamp(min=1e-300)).max())
    out["checks"]["8 chunks vs whole"] = r
    print(f"check 8 chunks vs the whole volume: error/bound {r!r}", flush=True)
    ok &= r <= 1.0
    odd = [torch.rand((511, 512, 257), device="cuda", generator=g) for _ in range(2)]
    ref = ck._shell_bin_unfolded_plain(odd[0].double(), odd[1].double(), 255, 512)
    got = ck.shell_bin_sums_unfolded(odd[0], odd[1], 255, 512)
    r = float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())
    out["checks"]["511x512x257"] = r
    print(f"check 511x512x257: error/bound {r!r}", flush=True)
    ok &= r <= 1.0
    print(json.dumps({"checks_ok": bool(ok)}), flush=True)
    if not ok:
        print(json.dumps(out), flush=True)
        sys.exit("the unfolded binning disagrees with its plain version")
    if "--quick" in sys.argv:
        return

    def inside(vol, nb, full_nz, kx0=0, full_nx=None):
        shell = ck._unfolded_shells(tuple(vol.shape), nb, full_nz, vol.device, kx0, full_nx)[0]
        return int((shell < nb).sum())

    chunk = (total[:rows], longi[:rows])
    cases = {  # name: (t, l, nx, ny, nzr, nbins, full_nz, kx0, full_nx, bound ms)
        "B6 (128, 1024, 513) kx0 0": (*chunk, rows, n, nzr, nbins, n, 0, n,
                                       least_ms(8 * inside(chunk[0], nbins, n) + 16 * nbins)),
        "B10 511x512x257": (*odd, 511, 512, 257, 255, 512, 0, 511,
                            least_ms(8 * inside(odd[0], 255, 512) + 16 * 255)),
    }
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    sources = {"shipped": ((CSRC / "spectra_kernels.cu").read_text(), CSRC)}
    sources.update({k: variant("spectra_kernels.cu", e) for k, e in WALK_VARIANTS.items()})
    old = sys.argv[sys.argv.index("--old") + 1] if "--old" in sys.argv else None
    if old:
        old_csrc = Path(old) / "fava_tpu_torch" / "csrc"
        sources["old (parent)"] = ((old_csrc / "spectra_kernels.cu").read_text(), old_csrc)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(nvcc, flags, sources, Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        for name, (t, lo, nx, ny, nz_r, nb, full_nz, kx0, full_nx, bound) in cases.items():
            res = torch.zeros((2, nb), dtype=torch.float64, device="cuda")
            times = {"bound_ms": bound}
            for lib_name, lib in libs.items():
                fn = lib.fava_shell_bin_sums_rfft_chunk
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
                bps = lib.fava_shell_bin_unfolded_blocks_per_sm(2, nb)
                times[f"{lib_name} blocks/SM"] = bps
                base = ck._wave_blocks(nx * ny, ck.BIN_MAX_WARPS, bps, sms)
                grids = {"": base}
                if lib_name == "shipped":
                    grids.update({" grid x2": 2 * base, " grid x4": 4 * base, " grid /2": max(1, base // 2)})
                for suffix, blocks in grids.items():
                    def run():
                        err = fn(t.data_ptr(), lo.data_ptr(), res.data_ptr(), nx, ny, nz_r, nb, full_nx,
                                 full_nz, kx0, 2, blocks, stream)
                        if err:
                            sys.exit(f"{lib_name}: launch error {err}")
                    times[lib_name + suffix] = cuda_ms(torch, run, 20)
            out["times"][name] = times
            print(f"times {name} (ms): {json.dumps(times)}", flush=True)

        def snapshot():
            for k in range(0, n, rows):
                ck.shell_bin_values_rfft_chunk(total[k : k + rows], longi[k : k + rows], nbins, n, n, k)

        out["times"]["B6 8 launches (one 1024^3 snapshot)"] = {
            "ms": cuda_ms(torch, snapshot, 5),
            "bound_ms": least_ms(8 * inside(total, nbins, n) + 8 * 16 * nbins)}
        print(f"times B6 snapshot: {json.dumps(out['times']['B6 8 launches (one 1024^3 snapshot)'])}",
              flush=True)
    del total, longi, odd, chunk
    torch.cuda.empty_cache()


def host_ms(fn, reps=200):
    """Host time a call (enqueue, no synchronize) over ``reps`` calls."""
    import time

    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def walk_probe(torch, _build, ck, out):
    """The folded kernels (K4, B4, B11a, B11b) and B9 at chip_smoke.py's
    512^3 shapes: checks, then C entry against wrapper, cut-out builds,
    other grids and another checkout's kernels."""
    for kernel in ("FoldedRows", "powers_fold_bin_kernel"):
        out[f"ptxas {kernel}"] = ptxas_lines(_build, kernel)
        for line in out[f"ptxas {kernel}"]:
            print(f"ptxas: {line}", flush=True)
        out[f"sass_atomics {kernel}"] = sass_atomics(_build, kernel)
        print(f"SASS atomics {kernel}: {json.dumps(out[f'sass_atomics {kernel}'])}", flush=True)
    n, nb = 512, 255
    nxh, nzr, rows8 = n // 2 + 1, n // 2 + 1, n // 2 + 1 + 7
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(3)
    folds = [torch.rand((nxh, nxh, nzr), device="cuda", generator=g) for _ in range(2)]
    padded = [torch.full((nxh, rows8, nzr), float("nan"), device="cuda") for _ in range(2)]
    for p_, f in zip(padded, folds):
        p_[:, :nxh] = f
    spec = torch.randn((3, n, n, nzr), dtype=torch.complex64, device="cuda", generator=g) / n**1.5
    ri = torch.view_as_real(spec)
    planar = (ri[..., 0].contiguous(), ri[..., 1].contiguous())
    launches = {
        "K4": ("fava_shell_bin_folded_blocks_per_sm", (2, 0), 2, nxh * nxh),
        "B4": ("fava_shell_bin_folded_blocks_per_sm", (1, 0), 1, nxh * nxh),
        "B11a": ("fava_shell_bin_folded_blocks_per_sm", (2, 1), 3, nxh * rows8),
        "B11b": ("fava_shell_bin_folded_blocks_per_sm", (2, 0), 2, nxh * rows8),
        "B9": ("fava_shell_bin_powers_fused_blocks_per_sm", (1,), 3, nxh * nxh),
        "B9 planar": ("fava_shell_bin_powers_fused_blocks_per_sm", (0,), 3, nxh * nxh),
    }
    out["walk launch"] = {k: ck.walk_launch(e, a, c, w, nb) for k, (e, a, c, w) in launches.items()}
    print(f"walk launch: {json.dumps(out['walk launch'])}; SMs {sms}", flush=True)

    def rel(got, ref):
        return float(((got - ref).abs() / (TOL_BIN * ref.abs()).clamp(min=1e-300)).max())

    ok = True
    ref = ck._onepass_plain(*(p_.double() for p_ in padded), nb, n, n, n)
    counts, sums = ck.shell_bin_sums_folded_onepass(*padded, nb, n, n, n)
    checks = {"K4": rel(ck.shell_bin_values_folded(*folds, nb, n, n), ref[1:]),
              "B4": rel(ck.shell_bin_values_folded_1ch(folds[1], nb, n, n), ref[2]),
              "B11a": rel(sums[:2], ref[1:]),
              "B11b": rel(torch.stack(ck.shell_bin_values_folded_rows(*padded, nb, n, n, n)), ref[1:])}
    ok &= bool(torch.equal(counts, ref[0]))
    for name, (re_, im_) in (("B9", (ri[..., 0], ri[..., 1])), ("B9 planar", planar)):
        ref9 = ck._powers_fused_plain(re_.double(), im_.double(), nb, n)
        c9, s9 = ck.shell_bin_powers_fused(re_, im_, nb, n)
        ok &= bool(torch.equal(c9, ref9[0]))
        checks[name] = rel(s9[:2], ref9[1:])
        del ref9
    for name, r in checks.items():
        out["checks"][f"walk {name}"] = r
        print(f"check {name} at 512^3: error/bound {r!r}", flush=True)
        ok &= r <= 1.0
    print(json.dumps({"walk_checks_ok": bool(ok), "counts_exact": bool(ok)}), flush=True)
    if not ok:
        print(json.dumps(out), flush=True)
        sys.exit("a walk kernel disagrees with its plain version")
    del ref
    torch.cuda.empty_cache()
    if "--quick" in sys.argv:
        return

    inside_f = int((ck._folded_shells(tuple(folds[0].shape), nb, n, "cuda") < nb).sum())
    inside_9 = int((ck._unfolded_shells((n, n, nzr), nb, n, "cuda")[0] < nb).sum())
    bounds = {"K4": least_ms(8 * inside_f + 16 * nb), "B4": least_ms(4 * inside_f + 8 * nb),
              "B11a": least_ms(8 * inside_f + 24 * nb), "B11b": least_ms(8 * inside_f + 16 * nb),
              "B9": least_ms(24 * inside_9 + 24 * nb), "B9 planar": least_ms(24 * inside_9 + 24 * nb)}
    wrappers = {
        "K4": lambda: ck.shell_bin_values_folded(*folds, nb, n, n),
        "B4": lambda: ck.shell_bin_values_folded_1ch(folds[1], nb, n, n),
        "B11a": lambda: ck.shell_bin_sums_folded_onepass(*padded, nb, n, n, n),
        "B11b": lambda: ck.shell_bin_values_folded_rows(*padded, nb, n, n, n),
        "B9": lambda: ck.shell_bin_powers_fused(ri[..., 0], ri[..., 1], nb, n),
        "B9 planar": lambda: ck.shell_bin_powers_fused(*planar, nb, n),
    }
    res = torch.zeros((3, nb), dtype=torch.float64, device="cuda")
    P, I = ctypes.c_void_p, ctypes.c_int
    # name: (source, C entry, its argtypes, its arguments but blocks and stream, occupancy query's args)
    entries = {
        "K4": ("flagship_kernels.cu", "fava_shell_bin_values_folded", [P] * 3 + [I] * 7,
               (folds[0].data_ptr(), folds[1].data_ptr(), res.data_ptr(), nxh, nxh, nzr, nb, n, n, 2)),
        "B4": ("flagship_kernels.cu", "fava_shell_bin_values_folded", [P] * 3 + [I] * 7,
               (folds[1].data_ptr(), None, res.data_ptr(), nxh, nxh, nzr, nb, n, n, 1)),
        "B11a": ("flagship_kernels.cu", "fava_shell_bin_sums_folded_onepass", [P] * 3 + [I] * 7,
                 (padded[0].data_ptr(), padded[1].data_ptr(), res.data_ptr(), nxh, rows8, nzr, nb, n, n, n)),
        "B11b": ("flagship_kernels.cu", "fava_shell_bin_values_folded", [P] * 3 + [I] * 7,
                 (padded[0].data_ptr(), padded[1].data_ptr(), res.data_ptr(), nxh, rows8, nzr, nb, n, n, 2)),
        "B9": (FUSED, "fava_shell_bin_powers_fused", [P] * 3 + [I] * 6,
               (ri.data_ptr(), None, res.data_ptr(), n, n, nzr, nb, n, 1)),
        "B9 planar": (FUSED, "fava_shell_bin_powers_fused", [P] * 3 + [I] * 6,
                      (planar[0].data_ptr(), planar[1].data_ptr(), res.data_ptr(), n, n, nzr, nb, n, 0)),
    }
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    sources = {f"{k} [{src}]": variant(src, e) for src, table in
               (("flagship_kernels.cu", WALK_VARIANTS), (FUSED, FUSED_VARIANTS)) for k, e in table.items()}
    old = sys.argv[sys.argv.index("--old") + 1] if "--old" in sys.argv else None
    if old:
        old_csrc = Path(old) / "fava_tpu_torch" / "csrc"
        for src in ("flagship_kernels.cu", FUSED):
            sources[f"old (parent) [{src}]"] = ((old_csrc / src).read_text(), old_csrc)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(nvcc, flags, sources, Path(tmp))
    stream = torch.cuda.current_stream().cuda_stream
    for name, (src, entry, argtypes, args) in entries.items():
        qentry, qargs, channels, nwalks = launches[name]
        times = {"bound_ms": bounds[name]}
        runs = {"shipped": (_build.library(), out["walk launch"][name]["blocks"])}
        grid = runs["shipped"][1]
        runs.update({"shipped grid x2": (_build.library(), 2 * grid),
                     "shipped grid /2": (_build.library(), max(1, grid // 2))})
        mangled = {"K4": "ILi2ELb0ENS_10FoldedRows", "B4": "ILi1ELb0ENS_10FoldedRows",
                   "B11a": "ILi2ELb1ENS_10FoldedRows", "B11b": "ILi2ELb0ENS_10FoldedRows",
                   "B9": "powers_fold_bin_kernelILb1", "B9 planar": "powers_fold_bin_kernelILb0"}[name]
        for lib_name, lib in libs.items():
            if not lib_name.endswith(f"[{src}]"):
                continue
            parent = {"FoldedRows": "shell_bin_folded_kernel" + mangled[:8]}.get(mangled[-10:], mangled)
            times[f"{lib_name} ptxas"] = " ".join(
                log_ptxas(BUILD_LOGS[lib_name], parent if lib_name.startswith("old") else mangled))
            if lib_name.startswith("old (parent)"):
                blocks = max(1, min(-(-nwalks // 8), 4 * sms))  # the parent's _bin_blocks
            else:
                bps = getattr(lib, qentry)(*qargs, nb)
                if bps <= 0:
                    times[lib_name] = f"occupancy query {bps}"
                    continue
                blocks = ck._wave_blocks(nwalks, ck.BIN_MAX_WARPS, bps, sms)
            runs[lib_name.rsplit(" [", 1)[0]] = (lib, blocks)
        for run_name, (lib, blocks) in runs.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes + [I, P]

            def run():
                err = fn(*args, blocks, stream)
                if err:
                    sys.exit(f"{name} {run_name}: launch error {err}")

            times[run_name] = cuda_ms(torch, run, 20)
        times["wrapper"] = cuda_ms(torch, wrappers[name], 20)
        times["wrapper host ms a call"] = host_ms(wrappers[name])
        torch.cuda.synchronize()
        shipped = getattr(_build.library(), entry)
        times["C entry host ms a call"] = host_ms(lambda: shipped(*args, grid, stream))
        torch.cuda.synchronize()
        out["times"][name] = times
        print(f"times {name} (ms): {json.dumps(times)}", flush=True)
    # Where a K4 wrapper call's host time goes: each step alone, many calls.
    dev = folds[0].device
    k4 = getattr(_build.library(), "fava_shell_bin_values_folded")
    steps = {
        "wrapper": wrappers["K4"],
        "shape and device checks": lambda: (ck._device_kind("k", *folds), ck._check_cuda("k", *folds),
                                            ck._check_bins("k", nb)),
        "torch.zeros (2, nbins) on the card": lambda: torch.zeros((2, nb), dtype=torch.float64, device=dev),
        "torch.empty (2, nbins) on the card": lambda: torch.empty((2, nb), dtype=torch.float64, device=dev),
        "grid (_walk_blocks)": lambda: ck._walk_blocks(*launches["K4"][:2], 2, nxh * nxh, nb, dev),
        "current stream": lambda: torch.cuda.current_stream().cuda_stream,
        "_launch of the C entry": lambda: ck._launch("shell_bin_values_folded", dev, k4, *entries["K4"][3], grid),
        "C entry alone": lambda: k4(*entries["K4"][3], grid, stream),
    }
    grid = out["walk launch"]["K4"]["blocks"]
    out["times"]["K4 wrapper host ms a call, by step"] = {k: host_ms(f, 500) for k, f in steps.items()}
    torch.cuda.synchronize()
    print(f"times K4 wrapper host ms a call, by step: {json.dumps(out['times']['K4 wrapper host ms a call, by step'])}",
          flush=True)
    del folds, padded, spec, ri, planar
    torch.cuda.empty_cache()


def regrid_plan(np, nblks, domain, refine_fn, ncells, window=None):
    from fava_tpu_torch.io.synthetic import build_amr_tree
    from fava_tpu_torch.ops.regrid import RegridPlan

    blocks = build_amr_tree(nblks, np.array(domain), refine_fn=refine_fn)
    plan = RegridPlan(
        block_bounds=np.stack([b.bounds for b in blocks]),
        node_type=np.array([b.node_type for b in blocks]),
        refine_level=np.array([b.level for b in blocks]), ncells_vec=np.array(ncells),
        nblks_vec=np.array(nblks), ndim=3,
        subdomain_coords=None if window is None else np.array(window))
    return plan, len(blocks)


def regrid_args(plan):
    return (*plan.device_tables("cuda"), plan.out_shape, tuple(plan.out_origin),
            tuple(plan.ncells_vec))


def regrid_probe(torch, _build, ck, out):
    import numpy as np

    import chip_smoke as cs

    out["regrid_ptxas"] = ptxas_lines(_build, "regrid_kernel")
    for line in out["regrid_ptxas"]:
        print(f"ptxas: {line}", flush=True)
    out["regrid_launch"] = {"blocks_per_sm narrow": ck.regrid_blocks_per_sm(False),
                            "blocks_per_sm wide": ck.regrid_blocks_per_sm(True),
                            "threads z for nz 512": ck._regrid_threads(512)}
    print(f"regrid launch: {json.dumps(out['regrid_launch'])}", flush=True)
    rng = np.random.default_rng(0)
    ok = True
    # (ncells, window, nfields, refine): odd nz, windows off a multiple of 4, scale 1 only, holes.
    small = {
        "scales 1-16, 1 field": ((8, 8, 8), ((0.05, 1.9), (0, 1), (0, 1)), 1, 5),
        "odd nz window, 4 fields": ((8, 8, 8), ((0.05, 1.9), (0.1, 0.9), (0.013, 0.77)), 4, 4),
        "origin off 4, 8 fields": ((4, 4, 6), ((0.3, 1.7), (0, 1), (0.17, 0.93)), 8, 3),
        "scale 1 only": ((8, 8, 8), ((0.0, 2.0), (0, 1), (0, 1)), 2, 1),
    }
    for name, (ncells, window, nf, depth) in small.items():
        plan, nb = regrid_plan(np, (2, 1, 1), ((0.0, 2.0), (0.0, 1.0), (0.0, 1.0)),
                               lambda b, lev, d=depth: d if b[0, 0] < 0.2 and b[1, 0] < 0.2 else 1,
                               ncells, window)
        stacks = [torch.from_numpy(rng.standard_normal((nb, *ncells))).float().cuda() for _ in range(nf)]
        args = regrid_args(plan)
        got = ck.regrid_fields(stacks, *args)
        torch.cuda.synchronize()
        eq = all(torch.equal(g, r) for g, r in zip(got, ck._regrid_plain(stacks, *args)))
        holes = args[0].clone()
        holes.view(-1)[::3] = -1
        got = ck.regrid_fields(stacks, holes, *args[1:])
        eq_holes = all(torch.equal(g, r) for g, r in zip(got, ck._regrid_plain(stacks, holes, *args[1:])))
        out["checks"][f"regrid {name}"] = {"shape": plan.out_shape, "exact": eq, "exact with holes": eq_holes}
        print(f"check regrid {name} {plan.out_shape}: exact {eq}, with holes {eq_holes}", flush=True)
        ok &= eq and eq_holes
    big = {}
    for name, window, nf in (("full domain, dens", None, 1), ("512^3 window, 4 fields", cs.AMR_WINDOW, 4)):
        plan, nb = regrid_plan(np, cs.AMR_NBLKS, cs.AMR_DOMAIN, cs.amr_refine, cs.AMR_NCELLS, window)
        g = torch.Generator(device="cuda").manual_seed(2)
        stacks = [torch.rand((nb, *cs.AMR_NCELLS), device="cuda", generator=g) for _ in range(nf)]
        args = regrid_args(plan)
        got = ck.regrid_fields(stacks, *args)
        torch.cuda.synchronize()
        eq = all(torch.equal(a, b) for a, b in zip(got, ck._regrid_plain(stacks, *args)))
        del got
        out["checks"][f"regrid {name}"] = {"shape": plan.out_shape, "exact": eq}
        print(f"check regrid {name} {plan.out_shape}: exact {eq}", flush=True)
        ok &= eq
        big[name] = (stacks, args, least_ms(cs.regrid_bytes(torch, ck, stacks, args)))
    print(json.dumps({"regrid_checks_ok": bool(ok)}), flush=True)
    if not ok:
        print(json.dumps(out), flush=True)
        sys.exit("the regrid disagrees with its plain version")
    if "--quick" in sys.argv:
        return
    old = sys.argv[sys.argv.index("--old") + 1] if "--old" in sys.argv else None
    sources = {k: (edited(CSRC / "amr_kernels.cu", e), CSRC) for k, e in REGRID_VARIANTS.items()}
    if old:
        old_csrc = Path(old) / "fava_tpu_torch" / "csrc"
        sources["old (parent)"] = ((old_csrc / "amr_kernels.cu").read_text(), old_csrc)
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(nvcc, flags, sources, Path(tmp))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (stacks, args, bound) in big.items():
        t = {"bound_ms": bound, "shipped": cuda_ms(torch, lambda: ck.regrid_fields(stacks, *args), 10)}
        (nx, ny, nz), ty, tz = args[3], *args[0].shape[1:]
        outs = [torch.empty(args[3], device="cuda") for _ in stacks]
        srcs = (ctypes.c_void_p * len(stacks))(*(s_.data_ptr() for s_ in stacks))
        dsts = (ctypes.c_void_p * len(stacks))(*(o.data_ptr() for o in outs))
        shifts = ck._regrid_shifts(args[2])
        lib = ck._build.library()
        stream = torch.cuda.current_stream().cuda_stream
        bps = ck.regrid_blocks_per_sm(False)
        th = ck._regrid_threads(nz)
        wave = bps * sms
        grids = {f"threads {n}": (n, ck._regrid_blocks(nx * ny, n)) for n in (16, 32, 64, 256)}
        grids.update({"one wave": (th, wave), "two waves": (th, 2 * wave), "four waves": (th, 4 * wave)})
        variants = {k: (lib, n, bl) for k, (n, bl) in grids.items()}
        for lname, so in libs.items():
            if lname != "old (parent)":
                variants[lname] = (so, th, ck._regrid_blocks(nx * ny, th))
        # Library references on the same bytes: write the outputs, copy the window's stacks.
        t["library fill_ of the outputs"] = cuda_ms(torch, lambda: [o.fill_(1.0) for o in outs], 10)
        if len(stacks) > 1:
            t["library copy_ into the outputs"] = cuda_ms(
                torch, lambda: [o.view(-1).copy_(s_.view(-1)[: o.numel()]) for o, s_ in zip(outs, stacks)], 10)
        if "old (parent)" in libs:
            variants["old (parent)"] = (libs["old (parent)"], min(256, 32 * -(-nz // 32)),
                                        max(1, min(nx * ny, 32 * sms)))
        for vname, (so, th, bl) in variants.items():
            fn = so.fava_regrid_fields
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + \
                [ctypes.c_longlong] * 14 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

            def run():
                err = fn(ctypes.addressof(srcs), ctypes.addressof(dsts), len(stacks), args[0].data_ptr(),
                         args[1].data_ptr(), shifts.data_ptr(), nx, ny, nz, *args[4], *args[5], ty, tz,
                         *stacks[0].shape[1:], bl, th, stream)
                if err:
                    sys.exit(f"{vname}: launch error {err}")

            t[vname] = cuda_ms(torch, run, 10)
            if vname == "old (parent)":
                torch.cuda.synchronize()
                ref = ck.regrid_fields(stacks, *args)
                t["old (parent) exact"] = all(torch.equal(a, b) for a, b in zip(outs, ref))
        out["times"][f"K7 {name}"] = t
        print(f"times K7 {name} (ms): {json.dumps(t)}", flush=True)


def main() -> None:
    sys.path.insert(0, str(HERE))
    import torch

    from fava_tpu_torch.ops import _build
    from fava_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    out = {"card": card, "checks": {}, "times": {}}
    parts = [a for a in ("--bin", "--walk", "--regrid") if a in sys.argv] or ["--bin", "--walk", "--regrid"]
    if "--bin" in parts:
        bin_probe(torch, _build, ck, out)
    if "--walk" in parts:
        walk_probe(torch, _build, ck, out)
    if "--regrid" in parts:
        regrid_probe(torch, _build, ck, out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
