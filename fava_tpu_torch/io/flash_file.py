"""FLASH HDF5 readers and writers (fava_tpu/io/flash_file.py:44-276).

Parameter tables ("real scalars", "integer runtime parameters", ...),
the "unknown names" list, UNK field datasets (stored (nblocks, nz, ny,
nx); read onto a device as (nblocks, nx, ny, nz) tensors, or as host
x-slabs for the streamed paths), block metadata and the tracer-particle
tables of part and checkpoint files (:283-321). The readers
and writers take an open ``h5lite.File`` (the port's own HDF5 codec,
``io/h5lite.py``; h5py's File offers the same calls).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.io import h5lite
from fava_tpu_torch.utils import HID_T

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

NGUARD: int = 4
MESH_MDIM: int = 3


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


def field_key(handle, name: str) -> str:
    """The dataset of a UNK field: FLASH pads names to 4 characters."""
    key = f"{name:4s}" if len(name) < 4 else name
    if key not in handle and name in handle:
        key = name
    if key not in handle:
        raise KeyError(f"{name} field not found in dataset")
    return key


def field_grid_shape(handle, name: str) -> tuple:
    """A UNK field's shape in grid order, (nblocks, nxb, nyb, nzb) (3D
    for bare volumes), from its stored (nblocks, nzb, nyb, nxb)."""
    stored = tuple(int(n) for n in handle[field_key(handle, name)].shape)
    return stored[:-3] + stored[-3:][::-1]


def read_field(handle, name: str, device, dtype: torch.dtype) -> torch.Tensor:
    """Read one UNK dataset onto ``device`` as ``dtype``, swapping the
    grid I and K axes.

    FLASH files store (nblocks, nzb, nyb, nxb); this returns
    (nblocks, nxb, nyb, nzb) (3D for bare volumes). The stored bytes go
    to the device as they are and the swap happens there: on the card it
    takes milliseconds, where a host transpose of a 512^3 field takes
    seconds.
    """
    raw = torch.from_numpy(handle[field_key(handle, name)][()]).to(device=device, dtype=dtype)
    return raw.transpose(-1, -3).contiguous()


def read_field_blocks(handle, name: str, b0: int = 0, b1: Optional[int] = None) -> np.ndarray:
    """Blocks [b0, b1) of a UNK field (all of them by default) in grid
    order, (b1-b0, nxb, nyb, nzb): a swapped view of the stored values in
    their stored type. A part is a hyperslab read of the leading axis
    (the other blocks never land in host memory)."""
    ds = handle[field_key(handle, name)]
    raw = ds[()] if b0 == 0 and b1 is None else ds[b0:b1]
    return np.swapaxes(raw, -1, -3)


def read_field_slab(handle, name: str, x0: int, x1: int) -> np.ndarray:
    """Read an x-slab [x0, x1) of a single-block uniform field
    (fava_tpu/io/flash_file.py:104).

    The file stores (1, nzb, nyb, nxb), so the slab is a strided read of
    the trailing axis (the whole field never lands in host memory). It
    comes back in grid order, (x1-x0, nyb, nzb), as a swapped view of
    the stored (nzb, nyb, x1-x0) values in their stored type: the slab
    stream (``ops/outofcore._slab_stream``) copies the stored layout to
    the device and swaps and casts there, as ``read_field`` does.
    """
    raw = handle[field_key(handle, name)][..., x0:x1]
    if raw.ndim == 4:
        if raw.shape[0] != 1:
            # Taking block 0 of multi-block data would make every streamed
            # analysis compute statistics of one block only.
            raise ValueError(
                f"read_field_slab expects single-block uniform data; got {raw.shape[0]} blocks"
            )
        raw = raw[0]
    return np.swapaxes(raw, -1, -3)


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


# ---------------------------------------------------------------------------
# Writers


def _write_parameter_table(handle, name: str, params: Dict[str, Any], kind: str) -> None:
    if kind == "real":
        dtype = HID_T.F64_PARAMETER
        conv = float
    elif kind == "integer":
        dtype = HID_T.I32_PARAMETER
        conv = int
    elif kind == "logical":
        dtype = HID_T.BOOL_PARAMETER
        conv = int
    elif kind == "string":
        dtype = HID_T.STR_PARAMETER
        conv = lambda v: f"{v:<256s}".encode()
    else:
        raise ValueError(f"Unknown parameter kind {kind}")

    data = np.array(
        [(f"{k:<256s}".encode(), conv(v)) for k, v in params.items()],
        dtype=dtype,
    )
    handle.create_dataset(name, data=data)


def write_parameters(
    handle,
    scalars: Dict[str, Dict[str, Any]],
    runtime_parameters: Dict[str, Dict[str, Any]],
) -> None:
    for kind in PARAMETER_KINDS:
        _write_parameter_table(
            handle, f"{kind} runtime parameters", runtime_parameters.get(kind, {}), kind
        )
        _write_parameter_table(handle, f"{kind} scalars", scalars.get(kind, {}), kind)


def write_block_metadata(
    handle,
    *,
    coordinates: np.ndarray,
    block_size: np.ndarray,
    bounding_box: np.ndarray,
    node_type: np.ndarray,
    refine_level: np.ndarray,
    gid: np.ndarray,
    which_child: np.ndarray,
    bflags: np.ndarray,
    processor_number: Optional[np.ndarray] = None,
    chk_file: bool = False,
) -> None:
    FT = HID_T.F64 if chk_file else HID_T.F32
    for key, value in (
        ("coordinates", coordinates),
        ("block size", block_size),
        ("bounding box", bounding_box),
    ):
        handle.create_dataset(key, data=np.asarray(value, dtype=np.float64), dtype=FT)
    for key, value in (
        ("node type", node_type),
        ("refine level", refine_level),
        ("gid", gid),
        ("which child", which_child),
        ("bflags", bflags),
        ("processor number", processor_number),
    ):
        if value is not None:
            handle.create_dataset(key, data=np.asarray(value, dtype=np.int32), dtype=HID_T.I32)


def write_unknown_names(handle, names: Sequence[str]) -> None:
    """The "unknown names" dataset. FLASH UNK names are S4 records, and
    numpy would silently truncate a longer name (recording b'myfi' for a
    dataset written as 'myfield'), so longer names raise here."""
    too_long = [n for n in names if len(n) > 4]
    if too_long:
        raise ValueError(
            f"FLASH field names must be <= 4 characters (S4 'unknown names' "
            f"records); got {too_long}"
        )
    data = np.array([[f"{n:4s}".encode()] for n in names], dtype=HID_T.UNKNOWN_NAMES)
    handle.create_dataset("unknown names", data=data, dtype=HID_T.UNKNOWN_NAMES)


def write_field(handle, name: str, data, chk_file: bool = False) -> None:
    """Write one UNK dataset (a numpy array or a tensor), swapping grid I
    and K axes back to file order (float64 for checkpoint files, float32
    otherwise). A tensor is swapped on its own device before it comes to
    the host."""
    FT = HID_T.F64 if chk_file else HID_T.F32
    if isinstance(data, torch.Tensor):
        swapped = data.transpose(-1, -3).contiguous().cpu().numpy()
    else:
        swapped = np.swapaxes(np.asarray(data), -1, -3)
    handle.create_dataset(name, data=swapped, dtype=FT)


def write_mesh_file(
    path: str | Path,
    *,
    scalars: Dict[str, Dict[str, Any]],
    runtime_parameters: Dict[str, Dict[str, Any]],
    metadata: Dict[str, np.ndarray],
    fields: Dict[str, Any],
    chk_file: bool = False,
) -> None:
    """Write a complete FLASH-layout mesh file (uniform/plt/chk); fields
    are numpy arrays or tensors in grid order."""
    with h5lite.File(path, "w") as f:
        write_parameters(f, scalars, runtime_parameters)
        write_metadata_dict(f, metadata, chk_file)
        write_unknown_names(f, list(fields.keys()))
        for name, data in fields.items():
            write_field(f, name, data, chk_file=chk_file)


def write_metadata_dict(handle, metadata: Dict[str, np.ndarray], chk_file: bool) -> None:
    """``write_block_metadata`` from a dict keyed by the dataset names."""
    write_block_metadata(
        handle,
        coordinates=metadata["coordinates"],
        block_size=metadata["block size"],
        bounding_box=metadata["bounding box"],
        node_type=metadata["node type"],
        refine_level=metadata["refine level"],
        gid=metadata["gid"],
        which_child=metadata["which child"],
        bflags=metadata["bflags"],
        processor_number=metadata.get("processor number"),
        chk_file=chk_file,
    )


# ---------------------------------------------------------------------------
# Particles


def read_particle_metadata(handle) -> Dict[str, Any]:
    """Particle-file metadata: the integer and real scalars, the per-rank
    counts ("localnp") and the column names ("particle names", S24
    records)."""
    int_scalars = read_parameter_table(handle, "integer scalars", string_values=False)
    real_scalars = read_parameter_table(handle, "real scalars", string_values=False)
    # atleast_1d: squeeze of a single-column file is 0-d (not iterable).
    names = [_decode(v).strip() for v in np.atleast_1d(np.squeeze(handle["particle names"][()]))]
    return {
        "integer scalars": int_scalars,
        "real scalars": real_scalars,
        "localnp": handle["localnp"][()],
        "particle names": names,
    }


def read_particles(
    handle, field_names: Sequence[str], select: Optional[Iterable[str]] = None
) -> Dict[str, np.ndarray]:
    """Bulk-read the "tracer particles" table into {field: host column}."""
    table = handle["tracer particles"][()]
    wanted = list(select) if select is not None else list(field_names)
    out: Dict[str, np.ndarray] = {}
    for k, field in enumerate(field_names):
        if field in wanted:
            out[field] = np.asarray(table[..., k])
    return out


def write_particle_file(
    path: str | Path,
    *,
    int_scalars: Dict[str, int],
    real_scalars: Dict[str, float],
    particles: Dict[str, np.ndarray],
) -> None:
    """Write a FLASH part file: the scalar tables, "localnp", the S24
    column names and the (N, ncolumns) float64 table."""
    names = list(particles.keys())
    nparticles = len(next(iter(particles.values()))) if particles else 0
    with h5lite.File(path, "w") as f:
        _write_parameter_table(f, "integer scalars", int_scalars, "integer")
        _write_parameter_table(f, "real scalars", real_scalars, "real")
        f.create_dataset("localnp", data=np.array([nparticles], dtype=np.int32))
        f.create_dataset(
            "particle names",
            data=np.array([[f"{n:24s}".encode()] for n in names], dtype="S24"),
        )
        table = np.stack([np.asarray(particles[n], dtype=np.float64) for n in names], axis=-1)
        f.create_dataset("tracer particles", data=table)
