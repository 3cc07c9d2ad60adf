"""fava_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernels take float32; the plain version gets the same values in float64.
Tolerances: row and block-row moments rtol 1e-10 (f64 sums in another
order); fold rtol 4e-7 (<= 3 float32 roundings of <= 4 positive terms);
shell sums rtol 1e-10 (f64 sums, atomics in run-dependent order);
regrid exact (values are copied).
"""

import numpy as np
import pytest
import torch

import fava_tpu_torch
from fava_tpu_torch import flagship
from fava_tpu_torch.io import synthetic
from fava_tpu_torch.ops import cuda_kernels as ck
from fava_tpu_torch.ops import regrid

SHAPE = (32, 32, 48)
BLOCKS = (40, 16, 16, 16)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(device, shape=SHAPE, seed=11):
    rng = np.random.default_rng(seed)
    f = [1.0 + 0.5 * rng.random(shape)] + [rng.standard_normal(shape) for _ in range(3)]
    return [torch.from_numpy(a).float().to(device) for a in f]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ck.KERNELS)
def test_kernel_matches_plain(cuda_device, kernel):
    f = _fields(cuda_device)
    f64 = [a.double() for a in f]
    ck.reset_launch_counts()
    if kernel in ("block_row_moments", "block_centered_row_moments"):
        b = _fields(cuda_device, shape=BLOCKS, seed=5)
        b64 = [a.double() for a in b]
        means = ck._block_row_moments_plain(*b64)[1:4] / (BLOCKS[2] * BLOCKS[3])
        if kernel == "block_row_moments":
            got, ref = ck.block_row_moments(*b), ck._block_row_moments_plain(*b64)
        else:
            got = ck.block_centered_row_moments(*b, means)
            ref = ck._block_centered_plain(*b64, means)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-9)
    elif kernel == "regrid_fields":
        plan, stacks = _regrid_inputs(cuda_device)
        tables = plan.device_tables(cuda_device)
        args = (plan.out_shape, tuple(plan.out_origin), tuple(plan.ncells_vec))
        got = ck.regrid_fields(stacks, *tables, *args)
        torch.cuda.synchronize()
        ref = ck._regrid_plain(stacks, *tables, *args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    elif kernel in ("row_moments", "centered_row_moments"):
        means = ck._row_moments_plain(*f64)[1:4] / (SHAPE[1] * SHAPE[2])
        if kernel == "row_moments":
            got, ref = ck.row_moments_volume(*f), ck._row_moments_plain(*f64)
        else:
            got, ref = ck.centered_row_moments(*f, means), ck._centered_plain(*f64, means)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-9)
    else:
        p = [a.abs()[:, :, : SHAPE[2] // 2 + 1].contiguous() for a in f[:2]]
        folded = ck.fold_quadrants_pair(*p)
        torch.cuda.synchronize()
        if kernel == "fold_quadrants_pair":
            for g, r in zip(folded, map(ck._fold_plain, (a.double() for a in p))):
                torch.testing.assert_close(g.double(), r, rtol=4e-7, atol=0)
        else:
            nbins = max(SHAPE) // 2 - 1
            got = ck.shell_bin_values_folded(*folded, nbins, SHAPE[1], SHAPE[2])
            torch.cuda.synchronize()
            ref = ck._shell_bin_folded_plain(
                *(a.double() for a in folded), nbins, SHAPE[1], SHAPE[2]
            )
            torch.testing.assert_close(got, ref, rtol=1e-10, atol=0)
    assert ck.launch_counts()[kernel] == 1


def _regrid_inputs(device, nfields=2):
    """A plan with scales 1-16 (levels 1-5 of 8^3 blocks) and random stacks."""
    from fava_tpu_torch.io.synthetic import build_amr_tree

    dom = np.array([[0.0, 2.0], [0.0, 1.0], [0.0, 1.0]])
    blocks = build_amr_tree(
        (2, 1, 1), dom, refine_fn=lambda b, lev: 5 if b[0, 0] < 0.2 and b[1, 0] < 0.2 else 1
    )
    plan = regrid.RegridPlan(
        block_bounds=np.stack([b.bounds for b in blocks]),
        node_type=np.array([b.node_type for b in blocks]),
        refine_level=np.array([b.level for b in blocks]),
        ncells_vec=np.array([8, 8, 8]),
        nblks_vec=np.array([2, 1, 1]),
        ndim=3,
        subdomain_coords=np.array([[0.05, 1.9], [0.0, 1.0], [0.0, 1.0]]),
    )
    assert int(plan.block_scales[plan.source_ids].max()) == 16
    rng = np.random.default_rng(3)
    stacks = [
        torch.from_numpy(rng.standard_normal((len(blocks), 8, 8, 8))).float().to(device)
        for _ in range(nfields)
    ]
    return plan, stacks


@pytest.mark.cuda
def test_regrid_copies_more_fields_than_one_launch_takes(cuda_device):
    plan, stacks = _regrid_inputs(cuda_device, nfields=ck.REGRID_MAX_FIELDS + 2)
    ck.reset_launch_counts()
    names = [str(i) for i in range(len(stacks))]
    got = regrid.regrid_fields(plan, dict(zip(names, stacks)), names)
    assert ck.launch_counts()["regrid_fields"] == 2
    tables = plan.device_tables(cuda_device)
    args = (plan.out_shape, tuple(plan.out_origin), tuple(plan.ncells_vec))
    for name, r in zip(names, ck._regrid_plain(stacks, *tables, *args)):
        assert torch.equal(got[name], r)


@pytest.mark.cuda
def test_amr_path_on_cuda_matches_the_cpu_path(cuda_device, tmp_path):
    synthetic.make_amr_file(
        tmp_path / "rt_hdf5_plt_cnt_0001", ncells=(16, 16, 16), nblks=(2, 1, 1), refine={0: 3}
    )
    window = np.array([[0.25, 0.75], [0.0, 1.0], [0.0, 1.0]])
    outs = {}
    for dev in ("cpu", "cuda"):
        m = fava_tpu_torch.FLASH(tmp_path, device=dev)
        m.load(file_type="plt")
        ck.reset_launch_counts()
        outs[dev] = (m.reynolds_stress(), m.favre_profiles())
        m.mesh.from_amr(subdomain_coords=window, fields=["dens", "velx"], save_file=False)
        assert m.mesh.nxb == 64  # the window was regridded: half of the 128-cell x extent
        outs[dev] += (m.mesh._data["dens"].cpu(),)
        counts = ck.launch_counts()
        if dev == "cuda":
            assert counts["block_row_moments"] == counts["block_centered_row_moments"] == 2
            assert counts["regrid_fields"] == 1
    (rs_c, fav_c, dens_c), (rs_g, fav_g, dens_g) = outs["cpu"], outs["cuda"]
    for g, r in zip([*rs_g[1].values(), *fav_g["favre_rms"].values()],
                    [*rs_c[1].values(), *fav_c["favre_rms"].values()]):
        assert float(np.abs(g - r).max()) <= 1e-9 * max(float(np.abs(r).max()), 1.0)
    assert torch.equal(dens_g, dens_c.float())


@pytest.mark.cuda
def test_step_on_cuda_matches_the_cpu_path(cuda_device):
    f = _fields(cuda_device, shape=(32, 32, 32))
    ck.reset_launch_counts()
    got = flagship.uniform_analysis_step(*f)
    counts = ck.launch_counts()
    assert all(counts[k] == 1 for k in ck.KERNELS[:4]) and sum(counts.values()) == 4
    ref = flagship.uniform_analysis_step(*(a.double().cpu() for a in f))
    for key, r in ref.items():
        g = got[key].cpu()
        bound = 1e-5 if key.startswith("spectra_") else 1e-9
        assert float((g - r).abs().max() / r.abs().max()) <= bound, key


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    f = _fields(cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ck.row_moments_volume(*(a.double() for a in f))
    with pytest.raises(ValueError, match="contiguous"):
        ck.row_moments_volume(*(a.transpose(0, 1) for a in f))
    with pytest.raises(NotImplementedError, match="B10"):
        p = torch.ones(15, 16, 9, device=cuda_device)
        ck.shell_bin_sums_rfft(p, p, 7, 16)
