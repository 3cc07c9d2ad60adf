"""Async HDF5 -> device ingest.

Counterpart of fava_tpu/io/ingest.py. A background thread pool reads
snapshot N+1 (and starts its host->device copy) while the device
computes on snapshot N. ``DeviceCopier`` is the copy half, shared with
the out-of-core slab stream (``ops/outofcore._slab_stream``):

* a worker thread copies each host array into a pinned staging buffer
  of its slot (casting to the wire dtype on the way, when one is set);
  a slot's buffers are refilled only after the event of their last
  copy has completed;
* the copy to the card runs on a side CUDA stream, followed on that
  stream by the widening to the field dtype and the swap into grid
  order (host arrays may be permuted views of the stored layout, as
  FLASH's (nz, ny, nx) order is); one event is recorded after them;
* the consumer's stream waits on that event, and each tensor is marked
  as used on the consumer's stream (``record_stream``) before the
  consumer sees it, so the allocator never hands its memory to the side
  stream while the consumer still reads it.

On the CPU (the tests) the same calls copy and cast in the worker, with
no staging and no streams.

Under a device mesh a placement callback (``sharding``, e.g.
``parallel.runtime.ingest_sharding_fn``) names each field's split: the
rank then reads only its rows from the file (an x-slab through
``flash_file.read_field_slab``, or a hyperslab of the block axis), and
nothing whole is read and then cut.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fava_tpu_torch.io import flash_file, h5lite
from fava_tpu_torch.utils import field_dtype, resolve_device


def _stored_layout(host) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(dense tensor in the host array's memory order, the permutation
    that turns it back into the array's axis order)."""
    t = torch.as_tensor(host)
    order = sorted(range(t.ndim), key=lambda a: -t.stride(a))
    base = t.permute(order)
    if not base.is_contiguous():
        base = base.contiguous()
    inverse = tuple(int(i) for i in np.argsort(order))
    return base, inverse


class DeviceCopier:
    """Host arrays to ``device`` in the field dtype, asynchronously
    (module docstring). ``slots`` staging sets rotate between the jobs
    in flight; give it the prefetch depth plus one."""

    def __init__(self, device, wire_dtype: Optional[torch.dtype], slots: int):
        self.device = resolve_device(device)
        self.dtype = field_dtype(self.device)
        self.wire_dtype = wire_dtype
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._staging: List[Dict[int, torch.Tensor]] = [{} for _ in range(slots)]
        self._last_copy: List[Optional[torch.cuda.Event]] = [None] * slots

    def put(self, slot: int, arrays: Sequence) -> Tuple[List[torch.Tensor], object, int]:
        """Worker side: (device tensors in the arrays' axis order, the
        event to wait on or None, bytes copied)."""
        if not self.cuda:
            outs, nbytes = [], 0
            for host in arrays:
                t = torch.as_tensor(host)
                if self.wire_dtype is not None:
                    t = t.to(self.wire_dtype)
                nbytes += t.numel() * t.element_size()
                outs.append(t.to(self.dtype).contiguous())
            return outs, None, nbytes
        slot %= len(self._staging)
        staging = self._staging[slot]
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if self._last_copy[slot] is not None:
                self._last_copy[slot].synchronize()  # the slot's buffers are free again
            outs, nbytes = [], 0
            for i, host in enumerate(arrays):
                base, inverse = _stored_layout(host)
                wire = self.wire_dtype or base.dtype
                buf = staging.get(i)
                if buf is None or buf.shape != base.shape or buf.dtype != wire:
                    buf = staging[i] = torch.empty(base.shape, dtype=wire, pin_memory=True)
                buf.copy_(base)
                dev = torch.empty(base.shape, dtype=wire, device=self.device)
                dev.copy_(buf, non_blocking=True)
                if inverse != tuple(range(dev.ndim)) or wire != self.dtype:
                    out = torch.empty(
                        tuple(base.shape[a] for a in inverse), dtype=self.dtype, device=self.device
                    )
                    dev = out.copy_(dev.permute(inverse))  # widen and swap on the card
                outs.append(dev)
                nbytes += buf.numel() * buf.element_size()
            event = torch.cuda.Event()
            event.record(self.stream)
            self._last_copy[slot] = event
        return outs, event, nbytes

    def take(self, tensors: List[torch.Tensor], event) -> List[torch.Tensor]:
        """Consumer side: make the current stream wait for the copies."""
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in tensors:
                t.record_stream(current)
        return tensors


def prefetched(load, count: int, depth: int):
    """Yield ``load(0)``, ..., ``load(count - 1)`` in order while up to
    ``depth`` background workers run the next calls. Stopping early (or a
    consumer that raises) cancels the calls not yet started, so nothing
    keeps reading and copying data nobody will use."""
    depth = max(1, int(depth))
    with cf.ThreadPoolExecutor(max_workers=depth) as pool:
        pending = [pool.submit(load, i) for i in range(min(depth, count))]
        nxt = len(pending)
        try:
            while pending:
                fut = pending.pop(0)
                if nxt < count:
                    pending.append(pool.submit(load, nxt))
                    nxt += 1
                yield fut.result()
        finally:
            for fut in pending:
                fut.cancel()
            pending.clear()


@dataclass
class Snapshot:
    """One ingested snapshot: device fields + host metadata."""

    path: Path
    time: float
    fields: Dict[str, torch.Tensor]
    scalars: Dict[str, Dict]
    runtime_parameters: Dict[str, Dict]
    metadata: Dict[str, np.ndarray]
    nbytes: int
    # Each field's ``parallel.runtime.Placement`` (None: read whole).
    placements: Dict[str, object] = field(default_factory=dict)


def _read_part(handle, name: str, grid, placement) -> np.ndarray:
    """A field in grid order (a view of the stored layout): whole, or
    this rank's rows of the placement's axis of the ``grid``-shaped
    field (an x-slab of a volume or a single block, or a run of blocks
    of a stack)."""
    if placement is None:
        return flash_file.read_field_blocks(handle, name)
    lo, hi = placement.bounds(int(grid[placement.axis]))
    if placement.axis == len(grid) - 3:
        slab = flash_file.read_field_slab(handle, name, lo, hi)
        return slab[None] if len(grid) == 4 else slab
    if placement.axis == 0 and len(grid) == 4:
        return flash_file.read_field_blocks(handle, name, lo, hi)
    raise ValueError(f"{name}: no partial read along axis {placement.axis} of a {grid} field")


def _read_snapshot(
    path: Path,
    fields: Sequence[str],
    copier: DeviceCopier,
    slot: int,
    sharding=None,
    strict: bool = True,
) -> Tuple[Snapshot, object]:
    """Worker side: (snapshot with its fields on the device, copy event).
    ``sharding`` is a placement, or a callback ``(name, grid-order
    shape) -> placement or None``."""
    with h5lite.File(path, "r") as f:
        scalars = flash_file.read_scalars(f)
        runtime = flash_file.read_runtime_parameters(f)
        meta = flash_file.read_block_metadata(f)
        available = flash_file.read_unknown_names(f)
        names, hosts, placements = [], [], {}
        for name in fields:
            if name not in available:
                # A silently dropped field surfaces later as a bare KeyError
                # deep inside a consumer; name the file here (strict=False
                # keeps the opportunistic skip).
                if strict:
                    raise KeyError(
                        f"field {name!r} not in {Path(path).name} (available: {sorted(available)})"
                    )
                continue
            grid = flash_file.field_grid_shape(f, name)
            placement = sharding(name, grid) if callable(sharding) else sharding
            # Viewed in grid order: the swap happens on the device.
            hosts.append(_read_part(f, name, grid, placement))
            names.append(name)
            placements[name] = placement
    tensors, event, nbytes = copier.put(slot, hosts)
    snap = Snapshot(
        path=Path(path),
        time=float(scalars["real"].get("time", 0.0)),
        fields=dict(zip(names, tensors)),
        scalars=scalars,
        runtime_parameters=runtime,
        metadata=meta,
        nbytes=nbytes,
        placements=placements,
    )
    return snap, event


class SnapshotPrefetcher:
    """Double-buffered iterator over a snapshot series.

    While the caller processes snapshot N, up to ``depth`` background
    workers read snapshots N+1..N+depth and copy them to ``device``.
    ``wire_dtype`` (e.g. ``torch.bfloat16``) casts on the host and widens
    on the device, at the cost of its rounding of the raw fields.
    ``sharding`` (a placement, or a callback as
    ``parallel.runtime.ingest_sharding_fn`` returns) makes the rank read
    only its rows of each field it places.
    """

    def __init__(
        self,
        paths: Sequence[str | Path],
        fields: Sequence[str],
        depth: int = 2,
        sharding=None,
        strict: bool = True,
        wire_dtype: Optional[torch.dtype] = None,
        device="cuda",
    ) -> None:
        self.paths = [Path(p) for p in paths]
        self.fields = list(fields)
        self.depth = max(1, int(depth))
        self.sharding = sharding
        self.strict = bool(strict)
        self.wire_dtype = wire_dtype
        self.device = resolve_device(device)

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Snapshot]:
        if not self.paths:
            return
        copier = DeviceCopier(self.device, self.wire_dtype, slots=self.depth + 1)

        def load(i: int):
            return _read_snapshot(self.paths[i], self.fields, copier, i, self.sharding, self.strict)

        with contextlib.closing(prefetched(load, len(self.paths), self.depth)) as snaps:
            for snap, event in snaps:
                copier.take(list(snap.fields.values()), event)
                yield snap


def ingest_bandwidth_gbps(
    paths: Sequence[str | Path],
    fields: Sequence[str],
    depth: int = 2,
    wire_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> float:
    """HDF5 -> device ingest rate over a series, in GB/s of bytes copied
    (with ``wire_dtype`` the wire bytes: the field rate is higher by the
    width ratio). The clock stops when every copy and swap has finished
    on the device."""
    dev = resolve_device(device)
    total = 0
    t0 = time.perf_counter()
    for snap in SnapshotPrefetcher(paths, fields, depth=depth, wire_dtype=wire_dtype, device=dev):
        total += snap.nbytes
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return total / (time.perf_counter() - t0) / 1e9
