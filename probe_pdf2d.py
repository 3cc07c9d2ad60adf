#!/usr/bin/env python3
"""Probe of the joint-histogram kernel B8 (pdf2d) on one NVIDIA GPU.

Run from the repository root:

    python3 probe_pdf2d.py [--quick] [--old DIR]
    python3 probe_pdf2d.py --walls [--old DIR]

It builds the kernels, prints B8's ptxas report, the atomics its SASS holds
(cuobjdump) and its launch, then makes three sample sets on the card: the
512^3 flame window of chip_smoke.py's AMR file (dens, velx at the cell
centres of [1.5, 2.5] x [0, 1] x [0, 1], the file's analytic fields, mass
weights), the 140 M leaf cells of its tree (volume weights), and 134 M
uncorrelated uniform random samples. On each it holds the counted and the
weighted kernel to their plain twin (``_pdf2d_plain``: counts exact, weight
sums within 1e-10 relative per bin) against 100 x 100 linspace edges over
the data's range, and prints the mean run length a sample (the samples in
a row on one bin) along the sample order and within the kernel's spans.
Then it times (CUDA events, warm) the kernel through its wrapper and its C
entry, beside builds of it with a part cut out or other constants
(VARIANTS: the cut-outs' results are wrong; only their times count),
another grid, and the kernel of the source tree ``DIR`` (a checkout of an
earlier commit) through its own C entry, each against its bound (the
samples and the output moved once at 3.35 TB/s). ``--quick`` stops after
the checks. ``--walls`` instead writes chip_smoke.py's AMR plt file to a
temporary directory and times (host clock around synchronized work,
warm) the leaves' ``pdf2d`` analyses, volume-weighted and unweighted, and
the steps of the weighted one (leaf stacks, weights, ranges, the kernel
through its wrapper); with ``--old DIR`` the same in a process that
imports the package of ``DIR``, between two runs of this tree's. Its last
line is all its results as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from probe_bin_regrid import build_libs, cuda_ms, edited, ptxas_lines, sass_atomics

HERE = Path(__file__).resolve().parent
CSRC = HERE / "fava_tpu_torch" / "csrc"
TOL_WSUM = 1e-10
HBM_BYTES_PER_S = 3.35e12
NBINS = 100

# Text edits of csrc/pdf2d_kernels.cu: cuts and other constants.
VARIANTS = {
    "without the loads (an L1-resident 8K samples)": [
        ("reinterpret_cast<const float4*>(p + i0);", "reinterpret_cast<const float4*>(p + (i0 & 8191));")],
    "without the binning (bin = int(64 v) & 63)": [
        ("  if (!(v >= a.lo && v <= a.hi)) return -1;\n", "  return (int)(v * 64.f) & 63;\n")],
    "guess only (no certify, no search)": [
        ("  if (g < (float)a.nb && f > a.fast_lo && f < a.fast_hi) return b;\n", "  return b;\n")],
    "without the shared adds": [("    atomicAdd(hist + bin, v);\n",
                                 "    if (v == Acc(0xfffffffd)) atomicAdd(hist + bin, v);\n")],
    "without the segment scan": [("    run = segment_sum(cur, run, lane, first);\n", "    first = true;\n")],
    "without the global flush": [("      if (v != Acc(0)) add_run<false>(hist, out, b, v);\n",
                                  "      if (v == Acc(0xfffffffd)) add_run<false>(hist, out, b, v);\n")],
    "span 16": [("constexpr int kSpan = 8;", "constexpr int kSpan = 16;")],
    "span 4": [("constexpr int kSpan = 8;", "constexpr int kSpan = 4;")],
    "threads 256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")],
    "launch bounds (512, 1)": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
}


def least_ms(nbytes):
    return 1e3 * nbytes / HBM_BYTES_PER_S


def window_samples(torch):
    """dens, velx at the 512^3 window's cell centres, and its mass weights
    (dens times the cell volume), float32, z fastest."""
    n = 512
    c = (torch.arange(n, device="cuda", dtype=torch.float64) + 0.5) / n
    x, y, z = (1.5 + c).view(n, 1, 1), c.view(1, n, 1), c.view(1, 1, n)
    two_pi = 2 * torch.pi
    dens = (1.0 + 0.5 * torch.sin(two_pi * x) * torch.cos(two_pi * y) + 0.1 * z).float()
    velx = (torch.sin(two_pi * y) + 0.3 * torch.cos(2 * two_pi * z)).expand(n, n, n).float().contiguous()
    mass = (dens.double() / n**3).float()
    return dens, velx, mass


def leaf_samples(torch, np):
    """dens, velx at the cell centres of the leaves of chip_smoke.py's
    rtflame-like tree, (nleaf, 16, 16, 16) z fastest, and their cell
    volumes."""
    import chip_smoke as cs
    from fava_tpu_torch.io.synthetic import build_amr_tree

    blocks = build_amr_tree(cs.AMR_NBLKS, np.array(cs.AMR_DOMAIN), refine_fn=cs.amr_refine)
    bounds = torch.as_tensor(np.stack([b.bounds for b in blocks if b.node_type == 1]), device="cuda")
    nc = cs.AMR_NCELLS[0]
    lo, width = bounds[:, :, 0], bounds[:, :, 1] - bounds[:, :, 0]
    c = (torch.arange(nc, device="cuda", dtype=torch.float64) + 0.5) / nc
    x = (lo[:, 0, None] + c * width[:, 0, None]).view(-1, nc, 1, 1)
    y = (lo[:, 1, None] + c * width[:, 1, None]).view(-1, 1, nc, 1)
    z = (lo[:, 2, None] + c * width[:, 2, None]).view(-1, 1, 1, nc)
    two_pi = 2 * torch.pi
    shape = (bounds.shape[0], nc, nc, nc)
    dens = (1.0 + 0.5 * torch.sin(two_pi * x) * torch.cos(two_pi * y) + 0.1 * z).expand(shape).float()
    velx = (torch.sin(two_pi * y) + 0.3 * torch.cos(2 * two_pi * z)).expand(shape).float()
    vol = (width.prod(dim=1) / nc**3).float().view(-1, 1, 1, 1).expand(shape)
    return dens.contiguous(), velx.contiguous(), vol.contiguous()


def run_lengths(torch, ck, x, y, xe, ye):
    """Mean samples a run (consecutive samples on one bin, the dropped ones
    counted as a bin of their own) along the sample order, and with the
    runs cut where the kernel's lane spans end."""
    bx = ck.bin_index(x, torch.as_tensor(xe, device=x.device))
    by = ck.bin_index(y, torch.as_tensor(ye, device=x.device))
    flat = torch.where((bx >= 0) & (by >= 0), bx * (len(ye) - 1) + by, -1)
    change = flat[1:] != flat[:-1]
    n = flat.numel()
    cut = change | (torch.arange(1, n, device=x.device) % ck.PDF2D_SPAN == 0)
    return {"mean_run": n / (1 + int(change.sum())), "mean_run_in_spans": n / (1 + int(cut.sum()))}


def check(torch, ck, x, y, w, xe, ye):
    got = ck.pdf2d_counts(x, y, xe, ye, weights=w)
    torch.cuda.synchronize()
    ref = ck._pdf2d_plain(x, y, xe, ye, w)
    if w is None:
        return 0.0 if torch.equal(got, ref) else float("inf")
    return float(((got - ref).abs() / (TOL_WSUM * ref.abs()).clamp(min=1e-300)).max())


def wall_ms(torch, fn, reps=5):
    """Median host ms of ``fn()`` ending in a synchronize, after a warm call."""
    import statistics

    import chip_smoke as cs

    return 1e3 * statistics.median(cs.wall_per_call(torch, fn, reps))


def amr_walls(workdir: str) -> dict:
    """The leaves' pdf2d walls and the weighted one's steps, with the
    fava_tpu_torch first on sys.path, on the plt file in ``workdir``."""
    import numpy as np
    import torch

    import fava_tpu_torch
    from fava_tpu_torch.ops import cuda_kernels as ck
    from fava_tpu_torch.ops import volume
    from fava_tpu_torch.utils import timing

    timing.VERBOSE = False
    m = fava_tpu_torch.FLASH(workdir)
    m.load(file_type="plt")
    mesh = m.mesh
    mesh.load_data(["dens", "velx"])
    d, v = mesh._leaf_stack("dens"), mesh._leaf_stack("velx")
    w = mesh._pdf_weights("volume", tuple(d.shape))
    xe, ye = (np.linspace(*volume._range(a), 101) for a in (d, v))
    return {
        "package": str(Path(fava_tpu_torch.__file__).parent),
        "pdf2d volume": wall_ms(torch, lambda: m.pdf2d("dens", "velx")),
        "pdf2d unweighted": wall_ms(torch, lambda: m.pdf2d("dens", "velx", weight=None)),
        "leaf stacks": wall_ms(torch, lambda: (mesh._leaf_stack("dens"), mesh._leaf_stack("velx"))),
        "volume weights": wall_ms(torch, lambda: mesh._pdf_weights("volume", tuple(d.shape))),
        "ranges": wall_ms(torch, lambda: (volume._range(d), volume._range(v))),
        "weighted kernel": wall_ms(torch, lambda: ck.pdf2d_counts(d, v, xe, ye, weights=w)),
        "counted kernel": wall_ms(torch, lambda: ck.pdf2d_counts(d, v, xe, ye)),
    }


def walls(torch, np, card) -> None:
    """--walls: the leaves' pdf2d walls of this tree, of ``--old DIR`` in a
    process of its own, and of this tree again."""
    import chip_smoke as cs

    old = sys.argv[sys.argv.index("--old") + 1] if "--old" in sys.argv else None
    out = {"card": card, "walls": []}
    with tempfile.TemporaryDirectory(prefix="fava_pdf2d_") as tmp:
        model, _ = cs.phase_amr_file(torch, np, Path(tmp))
        del model
        torch.cuda.empty_cache()
        for tree in ([None, old, None] if old else [None]):
            if tree is None:
                res = amr_walls(tmp)
            else:
                proc = subprocess.run([sys.executable, __file__, "--walls-of", str(Path(tree).resolve()), tmp],
                                      capture_output=True, text=True)
                if proc.returncode:
                    sys.exit(f"walls of {tree} failed:\n{proc.stdout}\n{proc.stderr}")
                res = json.loads(proc.stdout.strip().splitlines()[-1])
            out["walls"].append(res)
            print(f"walls (ms): {json.dumps(res)}", flush=True)
    print(json.dumps(out), flush=True)


def main() -> None:
    if "--walls-of" in sys.argv:  # a process of its own for another tree
        i = sys.argv.index("--walls-of")
        sys.path.insert(0, sys.argv[i + 1])
        print(json.dumps(amr_walls(sys.argv[i + 2])), flush=True)
        return
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from fava_tpu_torch.ops import _build
    from fava_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    _build.library()
    if "--walls" in sys.argv:
        walls(torch, np, card)
        return
    out = {"card": card, "ptxas": ptxas_lines(_build, "pdf2d_kernel"),
           "sass_atomics": sass_atomics(_build, "pdf2d_kernel"), "sets": {}}
    for line in out["ptxas"]:
        print(f"ptxas: {line}", flush=True)
    print(f"SASS atomics: {json.dumps(out['sass_atomics'])}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(9)
    n_rand = 134217728
    sets = {"window": window_samples(torch), "leaves": leaf_samples(torch, np),
            "random": tuple(torch.rand(n_rand, device="cuda", generator=g) for _ in range(3))}
    ok = True
    for name, (x, y, w) in sets.items():
        xe = np.linspace(float(x.min()), float(x.max()), NBINS + 1)
        ye = np.linspace(float(y.min()), float(y.max()), NBINS + 1)
        res = {"samples": x.numel(), **run_lengths(torch, ck, x, y, xe, ye)}
        for kind, weights in (("counted", None), ("weighted", w)):
            res[f"{kind} error/bound"] = r = check(torch, ck, x, y, weights, xe, ye)
            res[f"{kind} launch"] = ck.pdf2d_launch(x.numel(), NBINS, NBINS, weights is not None)
            ok &= r <= 1.0
        out["sets"][name] = res
        print(f"set {name}: {json.dumps(res)}", flush=True)
    print(json.dumps({"checks_ok": bool(ok)}), flush=True)
    if not ok:
        print(json.dumps(out), flush=True)
        sys.exit("the pdf2d kernel disagrees with its plain version")
    if "--quick" in sys.argv:
        print(json.dumps(out), flush=True)
        return

    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    sources = {k: (edited(CSRC / "pdf2d_kernels.cu", e), CSRC) for k, e in VARIANTS.items()}
    old = sys.argv[sys.argv.index("--old") + 1] if "--old" in sys.argv else None
    if old:
        old_csrc = Path(old) / "fava_tpu_torch" / "csrc"
        sources["old (parent)"] = ((old_csrc / "pdf2d_kernels.cu").read_text(), old_csrc)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_libs(nvcc, flags, sources, Path(tmp))
    libs = {"shipped": _build.library(), **libs}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (x, y, w) in sets.items():
        n = x.numel()
        xe = np.linspace(float(x.min()), float(x.max()), NBINS + 1)
        ye = np.linspace(float(y.min()), float(y.max()), NBINS + 1)
        table = torch.from_numpy(ck._pdf2d_table(xe, ye)).cuda()
        edges = [torch.as_tensor(e, device="cuda") for e in (xe, ye)]
        for kind, weights in (("counted", None), ("weighted", w)):
            wt = weights is not None
            res = torch.zeros((NBINS, NBINS), dtype=torch.float64 if wt else torch.int64, device="cuda")
            nbytes = 4 * (3 if wt else 2) * n + 8 * NBINS * NBINS
            t = {"bound_ms": least_ms(nbytes),
                 "wrapper": cuda_ms(torch, lambda: ck.pdf2d_counts(x, y, xe, ye, weights=weights), 20)}
            shared, smem = ck._pdf2d_layout(NBINS, NBINS, wt, ck._smem_optin(0))
            wp = None if weights is None else weights.data_ptr()
            for lname, lib in libs.items():
                fn = lib.fava_pdf2d
                if lname == "old (parent)":
                    fn.argtypes = [P] * 6 + [LL, I, I, I, I, P]
                    args = [x.data_ptr(), y.data_ptr(), wp, edges[0].data_ptr(), edges[1].data_ptr(),
                            res.data_ptr(), n, NBINS, NBINS, 1, max(1, min(-(-n // 1024), 4 * sms))]
                    grids = {"": args}
                else:
                    fn.argtypes = [P] * 5 + [LL, I, I, I, I, LL, I, P]
                    lib.fava_pdf2d_blocks_per_sm.argtypes = [I, I, LL]
                    bps = lib.fava_pdf2d_blocks_per_sm(int(wt), int(shared), smem)
                    t[f"{lname} blocks/SM"] = bps
                    base = [x.data_ptr(), y.data_ptr(), wp, table.data_ptr(), res.data_ptr(), n, NBINS,
                            NBINS, 1, int(shared), smem]
                    grids = {"": base + [bps * sms]}
                    if lname == "shipped":
                        grids[" grid x2"] = base + [2 * bps * sms]
                for suffix, args in grids.items():
                    def launch():
                        err = fn(*args, stream)
                        if err:
                            sys.exit(f"{lname}{suffix}: launch error {err}")
                    t[lname + suffix] = cuda_ms(torch, launch, 20)
                if lname == "old (parent)":
                    res.zero_()
                    launch()
                    torch.cuda.synchronize()
                    ref = ck.pdf2d_counts(x, y, xe, ye, weights=weights)
                    t["old (parent) agrees"] = bool(torch.equal(res, ref) if not wt else
                                                    torch.allclose(res, ref, rtol=1e-10, atol=0))
            out["sets"][name][f"{kind} ms"] = t
            print(f"times {name} {kind} (ms): {json.dumps(t)}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
