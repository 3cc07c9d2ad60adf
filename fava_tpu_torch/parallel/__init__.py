"""Multi-device runtime on ``torch.distributed``: the device mesh, the
slab placement of volumes, the halo exchange and packed reductions of
the rank-local analyses, the block and ingest placements and the pencil
FFT (fava_tpu/parallel/)."""

from fava_tpu_torch.parallel.runtime import (
    SNAP_AXIS,
    SPACE_AXIS,
    Placement,
    SpaceRanks,
    all_reduce_packed,
    block_sharding,
    device_axis_total,
    device_count,
    gather_slabs,
    get_mesh,
    halo_x,
    ingest_sharding_fn,
    ingest_volume_sharding,
    is_pod_mesh,
    make_device_mesh,
    replicated,
    set_mesh,
    shard_volume,
    shards_volume,
    snap_axis_size,
    space_axis_size,
    use_mesh,
    volume_sharding,
)
from fava_tpu_torch.parallel.fft import pencil_irfft, pfft3

__all__ = [
    "SNAP_AXIS",
    "SPACE_AXIS",
    "Placement",
    "SpaceRanks",
    "all_reduce_packed",
    "block_sharding",
    "device_axis_total",
    "device_count",
    "gather_slabs",
    "get_mesh",
    "halo_x",
    "ingest_sharding_fn",
    "ingest_volume_sharding",
    "is_pod_mesh",
    "make_device_mesh",
    "pencil_irfft",
    "pfft3",
    "replicated",
    "set_mesh",
    "shard_volume",
    "shards_volume",
    "snap_axis_size",
    "space_axis_size",
    "use_mesh",
    "volume_sharding",
]
