"""The port's spans read from a synthetic Chrome trace: device operations
credited to the stage that launched them, the host's synchronisations
counted by site, the idle inside the step, and nothing read without
``fava.*`` spans."""

import json

import pytest

from harness import roofline, spans, spec, trace
from harness.runner import Run

OWN = trace.own_kernel_names()
CELL = "rtflame512.series8"
NEW = ("transforms_ms_per_snapshot", "powers_ms_per_snapshot", "binning_ms_per_snapshot",
       "profiles_ms_per_snapshot", "host_syncs_per_snapshot", "step_idle_pct")


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 2.0, "args": {"correlation": corr}}


def _op(name, ts, dur, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _span("request", 0.0, 500.0),
    _span("request", 500.0, 500.0),
    _span("fava.transforms", 100.0, 100.0),
    _launch(110.0, 1),
    _launch(150.0, 2),
    _span("fava.powers", 200.0, 100.0),
    _launch(210.0, 3),
    _span("fava.binning", 300.0, 100.0),
    _span("fava.sync.counts", 320.0, 20.0),
    _launch(325.0, 4, "cudaMemcpyAsync"),
    _launch(328.0, 9, "cudaStreamSynchronize"),
    _launch(350.0, 5, "cuLaunchKernel", "cuda_driver"),
    _span("fava.profiles", 400.0, 80.0),
    _span("fava.sync.index", 420.0, 20.0),
    _launch(425.0, 7, "cudaMemcpyAsync"),
    _launch(428.0, 10, "cudaStreamSynchronize"),
    _launch(450.0, 8),
    _launch(700.0, 6),  # outside every stage: the series' stack
    _launch(900.0, 11, "cudaStreamSynchronize"),  # the harness's copy of an output
    _launch(1200.0, 12, "cudaDeviceSynchronize"),  # after the window
    _op("void at::native::vectorized_elementwise_kernel<4, sqrt>(...)", 120.0, 40.0, 1),
    # launched in fava.transforms, runs after that span closed on the host
    _op("void regular_fft<512u>(...)", 220.0, 40.0, 2),
    _op("void at::native::elementwise_kernel<128, 2>(...)", 260.0, 40.0, 3),
    _op("Memcpy HtoD (Pageable -> Device)", 330.0, 1.0, 4, "gpu_memcpy"),
    _op("shell_walk_kernel<2, false, FoldedRows>(...)", 360.0, 10.0, 5),
    _op("Memcpy HtoD (Pageable -> Device)", 430.0, 1.0, 7, "gpu_memcpy"),
    _op("row_moments_kernel(...)", 455.0, 20.0, 8),
    _op("void at::native::CatArrayBatchedCopy<...>(...)", 710.0, 10.0, 6),
    _op("void at::native::reduce_kernel<512, 1>(...)", 800.0, 10.0),  # no launch found
]


def _run(events, tmp_path, monkeypatch, snapshots=2):
    monkeypatch.setattr(spec, "CACHE_DIR", tmp_path)
    path = tmp_path / "traces" / f"{CELL}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
    return Run(cell=spec.load_cell(CELL), setup_s=1.0, snapshots=snapshots,
               trace=trace.parse(events, OWN), roles=spec.kernel_roles(),
               ctx=roofline.Ctx((64, 64, 64)))


def _read(run, names=NEW):
    return {n: spec.load_module("metrics", n).read(run) for n in names}


def test_ops_are_credited_to_the_stage_that_launched_them(tmp_path, monkeypatch):
    run = _run(EVENTS, tmp_path, monkeypatch)
    got = spans.read(run)
    assert got.device_us == {"fava.transforms": 80.0, "fava.powers": 40.0, "fava.binning": 11.0,
                             "fava.profiles": 21.0}
    assert got.syncs == {"fava.sync.counts": 1, "fava.sync.index": 1, "": 1}
    read = _read(run)
    assert read["transforms_ms_per_snapshot"] == pytest.approx(80e-3 / 2)
    assert read["powers_ms_per_snapshot"] == pytest.approx(40e-3 / 2)
    assert read["binning_ms_per_snapshot"] == pytest.approx(11e-3 / 2)
    assert read["profiles_ms_per_snapshot"] == pytest.approx(21e-3 / 2)
    assert read["host_syncs_per_snapshot"] == 1.5
    # Gaps whose midpoint on the host's clock (the launch that ends the
    # gap, less half the gap) lies in a stage: 160-220, 300-330, 331-360,
    # 370-430, 431-455; not 0-120 (ends at 110 - 60), 475-710 (700 -
    # 117.5), 720-800 (no launch found), 810-1000 (the window's last).
    assert read["step_idle_pct"] == pytest.approx(100 * (60 + 30 + 29 + 60 + 24) / 1000)
    idle = spec.load_module("metrics", "device_idle_pct").read(run)
    assert idle == pytest.approx(100 * (1000 - 172) / 1000) and idle > read["step_idle_pct"]


def test_a_device_clock_off_the_hosts_moves_no_gap(tmp_path, monkeypatch):
    """The device's timestamps 100 us behind the host's: every gap is
    placed by its closing launch, as with the clocks together (a gap's
    own midpoint would put 0-220 in fava.transforms and 470-530 outside
    every stage)."""
    late = [dict(e, ts=e["ts"] + 100.0) if e["cat"] in trace.DEVICE_CATS else e for e in EVENTS]
    run = _run(late, tmp_path, monkeypatch)
    assert spans.read(run).device_us == spans.credit(EVENTS).device_us
    read = spec.load_module("metrics", "step_idle_pct").read(run)
    assert read == pytest.approx(100 * (60 + 30 + 29 + 60 + 24) / 1000)


def test_the_innermost_stage_takes_the_op(tmp_path, monkeypatch):
    events = EVENTS + [_span("fava.transforms", 350.0, 10.0)]  # a stage inside fava.binning
    got = spans.read(_run(events, tmp_path, monkeypatch))
    assert got.device_us["fava.binning"] == 1.0 and got.device_us["fava.transforms"] == 90.0


def test_a_stage_that_ran_and_launched_nothing_reads_zero(tmp_path, monkeypatch):
    """fava.powers with its work moved into fava.binning reads 0; a stage
    whose span never ran reads None."""
    moved = [e for e in EVENTS if (e.get("args") or {}).get("correlation") != 3]
    read = _read(_run(moved, tmp_path, monkeypatch))
    assert read["powers_ms_per_snapshot"] == 0.0
    assert read["transforms_ms_per_snapshot"] == pytest.approx(80e-3 / 2)
    spans._read_file.cache_clear()
    gone = [e for e in EVENTS if e["name"] != "fava.powers"]
    read = _read(_run(gone, tmp_path, monkeypatch))
    assert read["powers_ms_per_snapshot"] is None
    assert read["binning_ms_per_snapshot"] == pytest.approx(11e-3 / 2)


def test_every_reader_finds_nothing_without_the_ports_spans(tmp_path, monkeypatch):
    events = [e for e in EVENTS if not e["name"].startswith("fava.")]
    run = _run(events, tmp_path, monkeypatch)
    assert spans.read(run) is None
    assert _read(run) == dict.fromkeys(NEW)
    assert spec.load_module("metrics", "eager_ms_per_snapshot").read(run) is not None


def test_a_trace_of_another_window_or_none_gives_nothing(tmp_path, monkeypatch):
    run = _run(EVENTS, tmp_path, monkeypatch)
    run.trace = trace.parse(EVENTS + [_span("request", 1000.0, 50.0)], OWN)  # another run's file
    assert _read(run) == dict.fromkeys(NEW)
    (tmp_path / "traces" / f"{CELL}.pt.trace.json").unlink()
    assert _read(run) == dict.fromkeys(NEW)
    run.trace = None
    assert _read(run) == dict.fromkeys(NEW)


def test_the_trace_is_parsed_once_a_run(tmp_path, monkeypatch):
    run = _run(EVENTS, tmp_path, monkeypatch)
    loads = []
    real = json.loads
    monkeypatch.setattr(spans.json, "loads", lambda s: loads.append(1) or real(s))
    spans._read_file.cache_clear()
    _read(run)
    assert len(loads) == 1


def test_the_stage_names_are_the_ports():
    from fava_tpu_torch.utils import profiling

    assert spans.STAGES == (profiling.SPAN_TRANSFORMS, profiling.SPAN_POWERS,
                            profiling.SPAN_BINNING, profiling.SPAN_PROFILES)
    for name in (profiling.SPAN_SYNC_COUNTS, profiling.SPAN_SYNC_INDEX,
                 profiling.SPAN_SYNC_OUTPUTS):
        assert name.startswith("fava.sync.")
