"""fava_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA
device. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernels take float32; the plain version gets the same values in float64.
Tolerances: row moments rtol 1e-10 (f64 sums in another order); fold
rtol 4e-7 (<= 3 float32 roundings of <= 4 positive terms); shell sums
rtol 1e-10 (f64 sums, atomics in run-dependent order).
"""

import numpy as np
import pytest
import torch

from fava_tpu_torch import flagship
from fava_tpu_torch.ops import cuda_kernels as ck

SHAPE = (32, 32, 48)


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
    if kernel in ("row_moments", "centered_row_moments"):
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


@pytest.mark.cuda
def test_step_on_cuda_matches_the_cpu_path(cuda_device):
    f = _fields(cuda_device, shape=(32, 32, 32))
    ck.reset_launch_counts()
    got = flagship.uniform_analysis_step(*f)
    assert all(v == 1 for v in ck.launch_counts().values())
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
