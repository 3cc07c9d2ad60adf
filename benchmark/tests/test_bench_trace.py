"""Trace classification, the window, idle gaps and the per-layer readers
on a synthetic event list."""

import math

import pytest

from harness import roofline, spec, trace
from harness.runner import Run

OWN = trace.own_kernel_names()


def test_own_kernel_names_come_from_csrc():
    for name in ("row_moments_kernel", "centered_row_moments_kernel", "fold_pair_kernel",
                 "shell_walk_kernel", "block_row_moments_kernel", "regrid_kernel",
                 "pdf2d_kernel", "powers_fold_bin_kernel", "zy_fft_kernel", "zy_rfft_kernel",
                 "zy_fft_tables_kernel", "block_centered_row_moments_kernel"):
        assert name in OWN


@pytest.mark.parametrize("name,cat,cls", [
    ("void row_moments_kernel(float const*, ...)", "kernel", "own"),
    ("void shell_walk_kernel<2, false, (anonymous namespace)::FoldedRows>(...)", "kernel", "own"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<c10::complex<float> >, std::array<char*, 2ul> >(int, ...)", "kernel", "torch"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...> >(...)", "kernel", "torch"),
    ("void regular_fft<512u, EPT<8u>, 64u, 8u, 2u, 0u, (fft_axii_t)2, ...>(...)", "kernel", "cufft"),
    ("void vector_fft_r2c<256u, EPT<8u>, 32u, 2u, ...>(...)", "kernel", "cufft"),
    ("void dpRadix0512B::kernel1MemPost<...>(...)", "kernel", "cufft"),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", "copy"),
    ("Memset (Device)", "gpu_memset", "copy"),
    ("some_vendor_kernel", "kernel", "other"),
])
def test_classify(name, cat, cls):
    assert trace.classify(name, cat, OWN) == cls


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev("request", "user_annotation", 100.0, 100.0),
    _ev("request", "user_annotation", 200.0, 100.0),
    _ev("aten::fft_rfftn", "cpu_op", 100.0, 20.0),
    _ev("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0),
    _ev("aten::copy_", "cpu_op", 280.0, 20.0),
    _ev("void regular_fft<512u>(...)", "kernel", 110.0, 30.0),          # busy 110-140
    _ev("void at::native::elementwise_kernel<128, 4>(...)", "kernel", 130.0, 20.0),  # to 150
    _ev("row_moments_kernel(...)", "kernel", 160.0, 40.0),               # 160-200
    _ev("shell_walk_kernel<2, false, FoldedRows>(...)", "kernel", 210.0, 10.0),
    _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 285.0, 5.0),
    _ev("row_moments_kernel(...)", "kernel", 50.0, 10.0),                # before the window
    _ev("gpu_span", "gpu_user_annotation", 100.0, 200.0),
]


def test_window_busy_and_gaps():
    t = trace.parse(EVENTS, OWN)
    assert (t.lo, t.hi) == (100.0, 300.0)
    assert len(t.ops) == 5
    assert t.busy_us() == 30 + 10 + 40 + 10 + 5
    assert t.gaps() == [(100.0, 110.0), (150.0, 160.0), (200.0, 210.0), (220.0, 285.0), (290.0, 300.0)]
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["row_moments_kernel(...)", 40e-6]
    assert b["idle_gaps"][0][1] == pytest.approx(65e-6)
    assert b["idle_gaps"][0][0] == "request"
    assert trace.Trace(0, 10, [], [{"name": "aten::copy_", "ts": 0, "dur": 10}]).host_at(5) == "aten::copy_"


def test_no_request_span_is_an_error():
    with pytest.raises(ValueError):
        trace.parse([e for e in EVENTS if e["name"] != "request"], OWN)


def test_per_layer_readers():
    cell = spec.load_cell("turb1024.flagship")
    t = trace.parse(EVENTS, OWN)
    run = Run(cell=cell, setup_s=12.5, snapshots=2, trace=t, roles=spec.kernel_roles(),
              ctx=roofline.Ctx((64, 64, 64)))
    read = {m["name"]: spec.load_module("metrics", m["name"]).read(run) for m in cell.per_layer}
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 95 / 200))
    assert read["device_ops_per_snapshot"] == 2.5
    assert read["copy_ms_per_snapshot"] == pytest.approx(5e-3 / 2)
    assert read["eager_ms_per_snapshot"] == pytest.approx(20e-3 / 2)
    assert read["cufft_ms_per_snapshot"] == pytest.approx(30e-3 / 2)
    ctx = run.ctx
    k1 = 1e6 * roofline.least_seconds(16 * 64**3 + 8 * 13 * 64, 22 * 64**3)
    inside = roofline.folded_inside(64, 64, 64, 31)
    k4 = 1e6 * roofline.least_seconds(8 * inside + 16 * 31, 8 * inside)
    assert ctx.nbins == 31
    assert read["cuda_kernels_roofline_pct"] == pytest.approx(100 * (k1 + k4) / 50)
    assert spec.load_module("metrics", "setup_s").read(run) == 12.5


def test_end_to_end_readers():
    cell = spec.load_cell("rtflame512.series8")
    run = Run(cell=cell, setup_s=9.0, snapshots=80, walls=[0.2] * 9 + [0.3], window_s=2.1,
              window_peak_bytes=21 * 2**30)
    read = {m["name"]: spec.load_module("metrics", m["name"]).read(run) for m in cell.end_to_end}
    assert read == {"snapshots_per_s": pytest.approx(80 / 2.1), "request_p90_ms": pytest.approx(200.0),
                    "peak_device_gib": 21.0, "setup_s": 9.0}
    walls = [0.1 * i for i in range(1, 101)]
    run.walls = walls
    assert spec.load_module("metrics", "request_p90_ms").read(run) == pytest.approx(9000.0)
    assert math.isclose(sorted(walls)[89], 9.0)


def test_readers_find_nothing_without_a_trace():
    cell = spec.load_cell("turb1024.flagship")
    run = Run(cell=cell, setup_s=1.0, snapshots=1)
    for m in cell.per_layer:
        assert spec.load_module("metrics", m["name"]).read(run) is None
