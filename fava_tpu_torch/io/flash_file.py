"""FLASH HDF5 readers (read side of fava_tpu/io/flash_file.py:44-163).

Parameter tables ("real scalars", "integer runtime parameters", ...),
the "unknown names" list, UNK field datasets (stored (nblocks, nz, ny,
nx); returned (nblocks, nx, ny, nz)) and block metadata. The readers
take an open ``h5py.File``; the callers that open files import h5py
themselves, so importing this module needs no h5py.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

PARAMETER_KINDS = ("real", "integer", "logical", "string")

# Canonical long-name -> 4-char UNK field names.
FIELD_MAPPING: Dict[str, str] = {
    "velocity-x": "velx",
    "velocity-y": "vely",
    "velocity-z": "velz",
    "density": "dens",
    "pressure": "pres",
    "temperature": "temp",
    "energy": "ener",
    "flame progress": "flam",
    "ignition time": "igtm",
    "velocity-divergence": "divv",
    "vorticity": "vort",
}


def _decode(value: Any) -> Any:
    if isinstance(value, bytes):
        return value.decode("utf-8").strip()
    return value


def read_parameter_table(handle, key: str, string_values: bool) -> Dict[str, Any]:
    """One compound (name, value) table -> {stripped name: value}."""
    if key not in handle:
        return {}
    table = handle[key][()]
    names = []
    for rec in table:
        name = _decode(rec["name"])
        names.append(name.strip() if isinstance(name, str) else name)
    if string_values:
        values = [_decode(rec["value"]) for rec in table]
    else:
        values = [rec["value"] for rec in table]
    return dict(zip(names, values))


def read_scalars(handle) -> Dict[str, Dict[str, Any]]:
    return {
        kind: read_parameter_table(handle, f"{kind} scalars", string_values=(kind == "string"))
        for kind in PARAMETER_KINDS
    }


def read_runtime_parameters(handle) -> Dict[str, Dict[str, Any]]:
    return {
        kind: read_parameter_table(
            handle, f"{kind} runtime parameters", string_values=(kind == "string")
        )
        for kind in PARAMETER_KINDS
    }


def read_unknown_names(handle) -> List[str]:
    names = np.atleast_1d(np.squeeze(handle["unknown names"][()]))
    return [_decode(n).strip() if isinstance(_decode(n), str) else str(n) for n in names]


def read_field(handle, name: str, dtype=np.float64) -> np.ndarray:
    """Read one UNK dataset, swapping the grid I and K axes.

    FLASH files store (nblocks, nzb, nyb, nxb); this returns
    (nblocks, nxb, nyb, nzb) (3D for bare volumes) in ``dtype``.
    """
    key = f"{name:4s}" if len(name) < 4 else name
    if key not in handle and name in handle:
        key = name
    if key not in handle:
        raise KeyError(f"{name} field not found in dataset")
    raw = handle[key][()]
    return np.ascontiguousarray(np.swapaxes(raw, -1, -3), dtype=dtype)


def read_block_metadata(handle) -> Dict[str, np.ndarray]:
    """All block bookkeeping datasets present in the file."""
    out: Dict[str, np.ndarray] = {}
    int_keys = {"node type", "refine level", "gid", "which child", "processor number", "bflags"}
    for key in (
        "coordinates",
        "block size",
        "bounding box",
        "node type",
        "refine level",
        "gid",
        "which child",
        "processor number",
        "bflags",
    ):
        if key in handle:
            data = handle[key][()]
            out[key] = data.astype(np.int64 if key in int_keys else np.float64)
    return out
