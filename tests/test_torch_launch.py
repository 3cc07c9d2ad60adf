"""Launch helpers of the unfolded shell binning (B6/B10) and the regrid (K7).

Pure Python: the grid and block shapes the wrappers in
fava_tpu_torch/ops/cuda_kernels.py hand to the CUDA kernels, held to what
the kernels in csrc/spectra_kernels.cu and csrc/amr_kernels.cu assume.
The walk's launch shared by every shell binning is tested in
tests/test_torch_walk.py.
"""

import pytest
import torch

from fava_tpu_torch.ops import cuda_kernels as ck


@pytest.mark.parametrize("nwalks,bps,sms,expect", [
    (0, 3, 132, 1), (1, 3, 132, 1), (8, 3, 132, 1), (9, 3, 132, 2),
    (128 * 1024, 3, 132, 396), (511 * 512, 3, 132, 396), (1000, 6, 132, 125),
])
def test_unfolded_blocks_cover_the_walks_up_to_the_card(nwalks, bps, sms, expect):
    blocks = ck._wave_blocks(nwalks, ck.BIN_MAX_WARPS, bps, sms)
    assert blocks == expect
    assert blocks <= max(1, bps * sms)
    # A warp for each walk, unless the card is full: then the warps stride.
    assert blocks * ck.BIN_MAX_WARPS >= nwalks or blocks == bps * sms


@pytest.mark.parametrize("shape,full_nz,walks", [
    ((128, 1024, 513), 1024, 128 * 1024), ((511, 512, 257), 512, 511 * 512),
    ((7, 6, 5), 5, 2 * 7 * 6), ((8, 8, 8), 8, 2 * 64),
])
def test_unfolded_launch_counts_two_walks_a_full_grid_row(monkeypatch, shape, full_nz, walks):
    seen = {}

    def blocks(nwalks, warps, bps, sms):
        seen.update(nwalks=nwalks, warps=warps, bps=bps, sms=sms)
        return 1

    monkeypatch.setattr(ck, "walk_blocks_per_sm", lambda entry, args, n, i=0: 3)
    monkeypatch.setattr(ck, "_smem_optin", lambda i: 232448)
    monkeypatch.setattr(ck, "_sm_count", lambda i: 132)
    monkeypatch.setattr(ck, "_wave_blocks", blocks)
    ck._unfolded_launch_blocks(shape, full_nz, 2, 255, torch.device("cpu"))
    assert seen == {"nwalks": walks, "warps": 8, "bps": 3, "sms": 132}


@pytest.mark.parametrize("nz", [1, 2, 3, 4, 5, 7, 8, 18, 48, 63, 64, 257, 512, 513, 1023, 2048])
def test_regrid_groups_cover_every_row_once(nz):
    """K7's groups start at 4g - a for a row whose first cell is a cells
    into its 4-cell group (a = (row * nz) % 4): every cell of the row in
    exactly one group, at every a the rows of this nz take."""
    groups = ck._regrid_groups(nz)
    for row in range(4):
        a = (row * nz) % 4
        cells = [4 * g - a + i for g in range(groups) for i in range(4)]
        inside = [z for z in cells if 0 <= z < nz]
        assert sorted(inside) == list(range(nz))
        if nz % 4 == 0:
            assert a == 0 and len(cells) == nz


@pytest.mark.parametrize("nz,threads", [(1, 1), (4, 1), (8, 2), (18, 8), (48, 16), (512, 16),
                                        (513, 16), (2048, 16)])
def test_regrid_threads_along_z(nz, threads):
    t = ck._regrid_threads(nz)
    assert t == threads
    assert t & (t - 1) == 0 and ck.REGRID_THREADS % t == 0  # the C entry's condition
    assert t >= min(ck._regrid_groups(nz), ck.REGRID_THREADS_Z)


@pytest.mark.parametrize("nrows,threads,expect", [
    (1, 16, 1), (16, 16, 1), (17, 16, 2), (512 * 512, 16, 16384), (2048 * 512, 16, 65536),
    (100, 1, 1), (257, 256, 257),
])
def test_regrid_blocks_cover_every_row(nrows, threads, expect):
    blocks = ck._regrid_blocks(nrows, threads)
    rows = ck.REGRID_THREADS // threads
    assert blocks == expect
    assert (blocks - 1) * rows < nrows <= blocks * rows


@pytest.mark.parametrize("out_shape,origin,ncells,tiles,wide", [
    ((2048, 512, 512), (0, 0, 0), (16, 16, 16), (32, 32), False),
    ((512, 512, 512), (768, 0, 0), (16, 16, 16), (32, 32), False),
    ((1 << 16, 1 << 15, 4), (0, 0, 0), (16, 16, 4), (2048, 1), True),
    ((4, 4, 4), (0, 0, (1 << 31) - 2), (4, 4, 4), (1, 1), True),
    ((4, 4, 4), (0, 0, 0), (4, 4, 1 << 20), (1, 1 << 11), True),  # z extent 2^31 fine cells
    ((4, 4, 4), (0, 0, 0), (4, 4, 1 << 20), (1, (1 << 11) - 1), False),
])
def test_regrid_index_width(out_shape, origin, ncells, tiles, wide):
    assert ck._regrid_wide(out_shape, origin, ncells, tiles) is wide
