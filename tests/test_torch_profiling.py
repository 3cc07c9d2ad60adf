"""The port's profiling, timing-trace, build-cache and NaN-check
utilities held to fava_tpu's on the CPU.

``device_trace``/``annotate`` (utils/profiling.py) write a torch.profiler
trace where fava_tpu writes a jax.profiler one; ``trace`` records into
``timings()`` as fava_tpu's does; ``enable_compilation_cache`` resolves
its directory in fava_tpu's order and points the kernel build there;
``enable_checks`` traps a NaN where ``jax_debug_nans`` does. The NaN
comparison runs both flagship steps in float64 on the same numpy input.

The flagship step's ``fava.*`` spans: free with no profiler running, in
order inside a CPU trace, and on the card (tests marked ``cuda``, which
use no JAX) every synchronisation of a warm step inside a
``fava.sync.*`` span and every device operation credited, by its launch,
to the stage that ran it. On the card, where there is no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_profiling.py
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the reference; the card's machine has no JAX, and the card tests use none
    import jax

    import fava_tpu
    from fava_tpu import flagship as jflag
    from fava_tpu.utils import cache as jcache
    from fava_tpu.utils import debug as jdebug
    from fava_tpu.utils import profiling as jprofiling
    from fava_tpu.utils import timing as jtiming
except ModuleNotFoundError:
    jax = fava_tpu = jflag = jcache = jdebug = jprofiling = jtiming = None

import fava_tpu_torch
from fava_tpu_torch import flagship, pipeline
from fava_tpu_torch.ops import _build
from fava_tpu_torch.utils import cache, debug, profiling, timing

NAMES = ("dens", "velx", "vely", "velz")


def _trace_events(logdir: Path):
    files = sorted(Path(logdir).glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_device_trace_writes_the_span_and_its_op(tmp_path):
    with profiling.device_trace(tmp_path / "port", device="cpu") as logdir:
        with profiling.annotate("span"):
            torch.ones(16, dtype=torch.float64).mul(3.0)
    assert logdir == str(tmp_path / "port")
    events = [e for e in _trace_events(logdir) if e.get("ph") == "X"]
    spans = [e for e in events if e["name"] == "span" and e.get("cat") == "user_annotation"]
    ops = [e for e in events if e["name"] == "aten::mul" and e.get("cat") == "cpu_op"]
    assert len(spans) == 1 and ops
    assert all(_inside(op, spans[0]) for op in ops)

    import jax.numpy as jnp

    with jprofiling.device_trace(tmp_path / "ref") as ref_dir:
        with jprofiling.annotate("span"):
            jnp.sum(jnp.arange(16.0)).block_until_ready()
    assert ref_dir == str(tmp_path / "ref") and (tmp_path / "ref").is_dir()


def test_device_trace_asks_for_cuda_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA trace is a card test")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.device_trace(tmp_path):
            pass


def test_device_trace_raises_when_the_device_records_nothing(monkeypatch, tmp_path):
    """A CUDA trace with no device event for a region that launched a
    hand-written kernel is an error, not an empty trace. Played on the
    CPU, where the profiler drops the CUDA activity with a warning: the
    device is taken for CUDA, and a kernel launch is counted."""
    from fava_tpu_torch.ops import cuda_kernels as ck

    monkeypatch.setattr(profiling, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with pytest.raises(RuntimeError, match="no device event"):
        with profiling.device_trace(tmp_path):
            monkeypatch.setitem(ck._LAUNCHES, "row_moments", ck._LAUNCHES["row_moments"] + 1)
    with profiling.device_trace(tmp_path / "quiet"):  # nothing launched: no error
        torch.ones(4).sum()


@pytest.mark.parametrize("mod", [timing, jtiming], ids=["port", "fava_tpu"])
def test_trace_round_trips_through_timings(mod):
    mod.reset_timings()
    with mod.trace("roundtrip"):
        pass
    assert "roundtrip" in mod.timings() and len(mod.timings()["roundtrip"]) == 1
    mod.reset_timings()
    assert "roundtrip" not in mod.timings()


def test_trace_records_inside_an_annotate_span(tmp_path):
    timing.reset_timings()
    with profiling.device_trace(tmp_path, device="cpu"):
        with timing.trace("step"):
            torch.ones(8).add(1.0)
    spans = [e for e in _trace_events(tmp_path) if e.get("ph") == "X" and e["name"] == "step"]
    assert len(spans) == 1 and spans[0]["cat"] == "user_annotation"
    assert len(timing.timings()["step"]) == 1
    timing.reset_timings()


STAGES = (profiling.SPAN_TRANSFORMS, profiling.SPAN_POWERS, profiling.SPAN_BINNING,
          profiling.SPAN_PROFILES)
# A snapshot's spans on the CPU by their start, and the stage that holds each
# sync span. B9's plain twin sends the static counts after its power volumes,
# outside the stages; on the card B9 counts the shells and sends none.
STEP_SPANS = [profiling.SPAN_TRANSFORMS, profiling.SPAN_POWERS, profiling.SPAN_SYNC_COUNTS,
              profiling.SPAN_BINNING, profiling.SPAN_PROFILES, profiling.SPAN_SYNC_INDEX]
HELD_BY = {profiling.SPAN_SYNC_INDEX: profiling.SPAN_PROFILES}


def _fava_spans(logdir):
    return sorted((e for e in _trace_events(logdir) if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation" and e["name"].startswith("fava.")),
                  key=lambda e: e["ts"])


def _assert_held(spans):
    """Each sync span lies inside the last span of the stage that holds it."""
    for i, e in enumerate(spans):
        if e["name"] in HELD_BY:
            outer = [o for o in spans[:i] if o["name"] == HELD_BY[e["name"]]][-1]
            assert _inside(e, outer), (e, outer)


def test_annotate_is_a_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*args):
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", refuse)
    with pytest.raises(AssertionError, match="no profiler running"):  # the patch bites
        with torch.profiler.record_function("span"):
            pass
    assert not torch.autograd._profiler_enabled()
    span = profiling.annotate(profiling.SPAN_POWERS)
    assert span is profiling.annotate("another") is profiling._OFF
    with span:
        pass
    timing.reset_timings()
    with timing.trace("untraced"):  # still records its wall sample
        pass
    assert len(timing.timings()["untraced"]) == 1
    timing.reset_timings()
    flagship.uniform_analysis_step(*flagship.make_example_fields(8, device="cpu"))


def test_series_step_records_its_stages_in_order(tmp_path):
    batch = flagship.make_example_field_batch(2, 16, device="cpu")
    ref = flagship.series_analysis_step(*batch)
    with profiling.device_trace(tmp_path, device="cpu"):
        out = flagship.series_analysis_step(*batch)
    spans = _fava_spans(tmp_path)
    assert [e["name"] for e in spans] == STEP_SPANS * 2
    _assert_held(spans)
    assert set(out) == set(ref) and all(torch.equal(out[k], ref[k]) for k in ref)


def test_flagship_analysis_records_its_stages_and_the_outputs_copy(tmp_path):
    fields = flagship.make_example_fields(16, device="cpu")
    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)), device="cpu")
    ref = model.flagship_analysis()
    with profiling.device_trace(tmp_path, device="cpu"):
        out = model.flagship_analysis()
    spans = _fava_spans(tmp_path)
    assert [e["name"] for e in spans] == STEP_SPANS + [profiling.SPAN_SYNC_OUTPUTS]
    _assert_held(spans)
    assert set(out) == set(ref) and all(np.array_equal(out[k], ref[k]) for k in ref)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _warm_step(entry: str, device):
    """The step a cell runs, called once: the kernels' build, the cached
    shell counts and cuFFT's plans are behind it."""
    batch = flagship.make_example_field_batch(2, 64, device=device)
    if entry == "series":
        step = lambda: flagship.series_analysis_step(*batch)  # noqa: E731
    else:
        model = fava_tpu_torch.from_arrays(dict(zip(NAMES, (f[0] for f in batch))), device=device)
        step = model.flagship_analysis
    step()
    torch.cuda.synchronize(device)
    return step


class _SyncSpan:
    """Stands in for record_function: the stream may synchronise inside a
    ``fava.sync.*`` span and raises anywhere else."""

    def __init__(self, name: str, entered: list):
        self.sync = name.startswith("fava.sync.")
        entered.append(name)

    def __enter__(self):
        if self.sync:
            torch.cuda.set_sync_debug_mode(0)
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.set_sync_debug_mode("error")
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("entry,syncs", [
    ("series", [profiling.SPAN_SYNC_INDEX] * 2),
    ("flagship_analysis", [profiling.SPAN_SYNC_INDEX, profiling.SPAN_SYNC_OUTPUTS]),
])
def test_every_synchronisation_of_a_warm_step_is_in_a_sync_span(cuda_device, monkeypatch, entry,
                                                                 syncs):
    step = _warm_step(entry, cuda_device)
    entered = []
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: _SyncSpan(name, entered))
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [n for n in entered if n.startswith("fava.sync.")] == syncs


# Device operations of known name and the stage that must launch them
# (None: outside every stage); the rest go wherever their launch lies.
LAUNCHED_IN = (
    (re.compile(r"fft", re.I), profiling.SPAN_TRANSFORMS),  # cuFFT's kernels
    (re.compile(r"row_moments_kernel"), profiling.SPAN_PROFILES),  # K1, K2
    (re.compile(r"powers_fold_bin_kernel"), profiling.SPAN_POWERS),  # B9
    (re.compile(r"fold_pair_kernel|shell_walk_kernel"), profiling.SPAN_BINNING),  # K3, K4
    (re.compile(r"^Memcpy DtoH"), None),  # the outputs
)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,snapshots", [("series", 2), ("flagship_analysis", 1)])
def test_device_ops_are_credited_to_the_stage_that_launched_them(cuda_device, tmp_path, entry,
                                                                 snapshots):
    """Every device operation of a traced step has its launch on the host
    (the same correlation id), and the innermost stage span around the
    launch is the stage that ran it: the rule the benchmark's stage
    metrics read. The device's timestamps are not compared with the
    host's: they drift apart, by up to milliseconds in one trace."""
    step = _warm_step(entry, cuda_device)
    with profiling.device_trace(tmp_path, device=cuda_device):
        step()
    events = [e for e in _trace_events(tmp_path) if e.get("ph") == "X"]
    stages = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in STAGES]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    credited = {name: [] for name in STAGES + (None,)}
    for op in events:
        if op.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched_at[op["args"]["correlation"]]
        held = [s for s in stages if s["ts"] <= t <= s["ts"] + s["dur"]]
        stage = min(held, key=lambda s: s["dur"])["name"] if held else None
        credited[stage].append(op["name"])
        for pattern, want in LAUNCHED_IN:
            if pattern.search(op["name"]):
                assert stage == want, (op["name"], stage)
    assert all(credited[name] for name in STAGES), credited
    b9 = re.compile(r"(?<![A-Za-z0-9_])powers_fold_bin_kernel\b")
    assert sum(bool(b9.search(n)) for n in credited[profiling.SPAN_POWERS]) == snapshots
    host_copies = {name: sum(n.startswith("Memcpy HtoD") for n in credited[name])
                   for name in STAGES}
    # the covariance diagonal's index, the one copy the step sends
    assert host_copies == {**dict.fromkeys(STAGES, 0), profiling.SPAN_PROFILES: snapshots}


@pytest.fixture()
def restored_build(monkeypatch):
    """The build module's directory and load marker, restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_LOADED", None)
    return monkeypatch


@pytest.fixture()
def restored_jax_cache():
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("source", ["path", "env", "default"])
def test_enable_compilation_cache_resolves_as_fava_tpu(restored_build, restored_jax_cache, tmp_path,
                                                       source):
    monkeypatch = restored_build
    monkeypatch.delenv("FAVA_TPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("FAVA_TPU_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setattr(jcache, "_DEFAULT", tmp_path / "ref_default")
    monkeypatch.setattr(_build, "DEFAULT_BUILD_DIR", tmp_path / "port_default")
    arg = {}
    if source == "path":
        arg = {"path": tmp_path / "explicit"}
        monkeypatch.setenv("FAVA_TPU_CACHE_DIR", str(tmp_path / "ref_env"))
        monkeypatch.setenv("FAVA_TPU_TORCH_CACHE_DIR", str(tmp_path / "port_env"))
    elif source == "env":
        monkeypatch.setenv("FAVA_TPU_CACHE_DIR", str(tmp_path / "ref_env"))
        monkeypatch.setenv("FAVA_TPU_TORCH_CACHE_DIR", str(tmp_path / "port_env"))
    ref = jcache.enable_compilation_cache(**arg)
    got = cache.enable_compilation_cache(**arg)
    want = {"path": ("explicit", "explicit"), "env": ("ref_env", "port_env"),
            "default": ("ref_default", "port_default")}[source]
    assert (ref, got) == (tmp_path / want[0], tmp_path / want[1])
    assert got.is_dir() and ref.is_dir()
    assert _build.BUILD_DIR == got.resolve()
    assert _build.library_path().parent == got.resolve()
    assert fava_tpu_torch.utils.enable_compilation_cache is cache.enable_compilation_cache


def test_enable_compilation_cache_raises_after_a_load(restored_build, tmp_path):
    monkeypatch = restored_build
    monkeypatch.delenv("FAVA_TPU_TORCH_CACHE_DIR", raising=False)
    first = cache.enable_compilation_cache(tmp_path / "first")
    monkeypatch.setattr(_build, "_LOADED", _build.library_path())  # as library() leaves it
    assert cache.enable_compilation_cache(tmp_path / "first") == first  # the same directory: fine
    with pytest.raises(RuntimeError, match="already loaded") as err:
        cache.enable_compilation_cache(tmp_path / "second")
    assert str(first.resolve()) in str(err.value) and str(tmp_path / "second") in str(err.value)
    assert _build.BUILD_DIR == first.resolve()


def test_pipeline_main_enables_the_cache(monkeypatch, tmp_path):
    class Called(Exception):
        pass

    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        raise Called

    monkeypatch.setattr(fava_tpu_torch.utils, "enable_compilation_cache", record)
    with pytest.raises(Called):
        pipeline.main(tmp_path, device="cpu")
    assert calls == [((), {})]


@pytest.fixture()
def checks_off():
    try:
        yield
    finally:
        debug.disable_checks()
        jdebug.disable_checks()


def test_debug_toggles(checks_off):
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    debug.enable_checks(nan_checks=True)
    assert debug.NAN_CHECKS and isinstance(_get_current_dispatch_mode(), debug._NanCheck)
    debug.enable_checks(nan_checks=True)  # a second call stacks nothing
    debug.disable_checks()
    assert not debug.NAN_CHECKS and _get_current_dispatch_mode() is None
    debug.enable_checks(nan_checks=False, disable_jit=True)  # disable_jit: nothing in eager torch
    assert not debug.NAN_CHECKS and _get_current_dispatch_mode() is None


def test_nan_check_names_the_op_and_ignores_inf(checks_off):
    debug.enable_checks()
    torch.tensor([1.0, float("inf")]) * 2.0  # Inf passes, as in JAX
    torch.tensor([1, 2]) + 1  # integer outputs are not checked
    with pytest.raises(FloatingPointError, match="nan.*aten.sqrt"):
        torch.sqrt(torch.tensor([1.0, -1.0]))
    with pytest.raises(FloatingPointError, match="aten"):
        torch.complex(torch.tensor([float("nan")]), torch.tensor([0.0])) * 1.0
    debug.disable_checks()
    assert torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all()


def test_nan_check_skips_allocations_and_views(checks_off):
    """Uninitialized memory may hold NaN bits until something writes it,
    and a view computes nothing: neither raises; computing on them does."""
    x = torch.full((4,), float("nan"))
    debug.enable_checks()
    x.view(2, 2)
    x[1:]
    torch.empty_like(x)
    torch.empty(3)
    x.new_empty((2,))
    with pytest.raises(FloatingPointError, match="aten.add"):
        x + 1.0


def test_nan_check_of_a_kernel_output(checks_off):
    """The launch helper's check (run after a kernel's launch on the
    card) names the kernel."""
    out = torch.zeros(3, dtype=torch.float64)
    debug.check_outputs("the CUDA kernel of k", (out, torch.zeros(2, dtype=torch.int64)))
    out[1] = float("nan")
    with pytest.raises(FloatingPointError, match="the CUDA kernel of k"):
        debug.check_outputs("the CUDA kernel of k", (out,))


def _fields(n, nan_at=None):
    rng = np.random.default_rng(5)
    f = [1.0 + 0.5 * rng.random((n, n, n))] + [rng.standard_normal((n, n, n)) for _ in range(3)]
    if nan_at is not None:
        f[0][nan_at] = np.nan
    return f


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "nan_in_dens"])
def test_enable_checks_traps_a_nan_as_fava_tpu(checks_off, planted):
    fields = _fields(12, (3, 5, 7) if planted else None)
    model = fava_tpu_torch.from_arrays(dict(zip(NAMES, fields)), device="cpu")
    saved = {k: getattr(jax.config, k) for k in ("jax_debug_nans", "jax_disable_jit")}
    # jax_debug_nans checks a cached executable's outputs through a post
    # hook that JAX keeps per thread too; after some runs of fava_tpu's
    # pipeline in the same process the thread's hook is left None and hides
    # the global flag, so the reference also runs under the thread-local
    # debug_nans context, which sets the hook again.
    try:
        jdebug.enable_checks()
        debug.enable_checks()
        if planted:
            with pytest.raises(FloatingPointError), jax.debug_nans(True):
                jflag.uniform_analysis_step(*(jax.numpy.asarray(a) for a in fields))
            with pytest.raises(FloatingPointError):
                model.flagship_analysis()
        else:
            with jax.debug_nans(True):
                ref = jflag.uniform_analysis_step(*(jax.numpy.asarray(a) for a in fields))
            out = model.flagship_analysis()
            assert set(out) == set(ref)
            assert all(np.isfinite(np.asarray(v)).all() for v in out.values())
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        debug.disable_checks()
    if planted:  # checks off: the NaN goes through
        out = model.flagship_analysis()
        assert np.isnan(np.asarray(out["mean_dens"])).any()


def test_port_utils_match_fava_tpu_signatures():
    import inspect

    pairs = [
        (profiling.annotate, jprofiling.annotate),
        (timing.trace, jtiming.trace),
        (cache.enable_compilation_cache, jcache.enable_compilation_cache),
        (debug.enable_checks, jdebug.enable_checks),
        (debug.disable_checks, jdebug.disable_checks),
    ]
    for port, ref in pairs:
        assert list(inspect.signature(port).parameters) == list(inspect.signature(ref).parameters)
    assert list(inspect.signature(profiling.device_trace).parameters) == ["logdir", "device"]
    assert list(inspect.signature(jprofiling.device_trace).parameters) == ["logdir"]
    assert fava_tpu.utils.trace is jtiming.trace and fava_tpu_torch.utils.trace is timing.trace


FAKE_NVCC = """#!/bin/sh
# Stands in for nvcc: writes the file after -o, says what ptxas would.
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "ptxas info    : Used 32 registers"
echo built > "$out"
"""


def test_build_compiles_each_source_into_the_cache_and_times_it(restored_build, tmp_path):
    """``build()`` runs one compiler per source and one link into the
    directory ``enable_compilation_cache`` chose, and records each
    source's compile seconds in BUILD_LOG (a stand-in compiler here)."""
    monkeypatch = restored_build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_LOG", None)
    cache_dir = cache.enable_compilation_cache(tmp_path / "kernels")
    lib = _build.build()
    assert lib.parent == cache_dir.resolve() and lib.read_text() == "built\n"
    heads = [ln for ln in _build.BUILD_LOG.splitlines() if ln.startswith("== ")]
    assert [h.split(":")[0] for h in heads] == ["== a.cu", "== b.cu"]
    for h in heads:
        secs = float(h.split(": ")[1].removesuffix(" s"))
        assert 0.0 <= secs < 60.0
    assert _build.BUILD_LOG.count("Used 32 registers") == 3  # two compiles and the link
    assert _build.build() == lib  # keyed by the sources: found, not rebuilt
