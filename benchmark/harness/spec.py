"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics. Everything that belongs to one configuration, traffic mix,
per-layer metric or kernel role is a file of its own under ``benchmark/``,
found by the name that ``BENCHMARK.json`` or the traffic file gives:

- ``configs/<config>.json``: the deployment's shape, fields, dtype and
  generator (the path is the config's ``file`` in ``BENCHMARK.json``);
- ``traffic/<traffic>.json``: the entry, the batch, the fields it reads,
  the reference and the request counts;
- ``limits/<workload>.json``: the limit of each number that ``correct``
  compares in that cell;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``kernels/<role>.py``: a kernel role (trace names, launch counters and
  the work of one launch), every file of the folder;
- ``generators/<generator>.py``: ``fill(out, args, gen)``;
- ``reference/<reference>.py``: the plain float64 reference.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(path: Path | None = None) -> dict:
    path = ROOT / "BENCHMARK.json" if path is None else Path(path)
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict | None = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` (BENCHMARK.json when None) with
    its configuration, traffic and limits read from their files."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((bench_dir.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits={k: float(v) for k, v in limits.items() if not k.startswith("_")},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_roles(bench_dir: Path = BENCH_DIR) -> List[ModuleType]:
    """Every kernel role under ``benchmark/kernels/``, by file name."""
    return [load_module("kernels", p.stem, bench_dir)
            for p in sorted((bench_dir / "kernels").glob("*.py")) if not p.stem.startswith("_")]
