"""Distributed 3D FFT over the mesh's space axis (slab decomposition).

Counterpart of fava_tpu/parallel/fft.py, on ``torch.distributed``:

  input: the rank's x-slab (nx/d, ny, nz)
    1. local FFT over the two resident axes (y, z)
    2. ``all_to_all_single`` on the space group: x <-> y transpose
    3. local FFT over the now-resident x axis
  output: the rank's y-slab (nx, ny/d, nz)

and back (``pencil_irfft``): the inverse FFT along x of the rank's
y-slab, the y <-> x exchange (``transpose_yx``), the inverse real
transform over (y, z).

Shell-binned spectra are permutation-invariant in k, so the output stays
in unshifted k order; callers build the matching local k-grid from
``_wavenumbers`` (ops/spectra.local_spectra_fn slices the y wavenumbers
to its slab).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fava_tpu_torch.parallel import runtime


def transpose_xy(local: torch.Tensor, mesh, axis_name: str = runtime.SPACE_AXIS) -> torch.Tensor:
    """(nx/d, ny, m) x-slab -> (nx, ny/d, m) y-slab over the ``axis_name``
    group of ``mesh``: one ``all_to_all_single``. It splits and
    concatenates along dim 0 only, so the block bound for rank j (its y
    rows) is made the major index first; after the exchange the source
    rank is the major index, which is global x order. Complex tensors
    travel as their real views (NCCL takes no complex dtype)."""
    d = runtime.axis_size(mesh, axis_name)
    nxl, ny, m = (int(s) for s in local.shape)
    if ny % d:
        raise ValueError(f"y extent {ny} does not split over {d} ranks")
    send = local.reshape(nxl, d, ny // d, m).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    if send.is_complex():
        dist.all_to_all_single(
            torch.view_as_real(recv), torch.view_as_real(send), group=mesh.get_group(axis_name)
        )
    else:
        dist.all_to_all_single(recv, send, group=mesh.get_group(axis_name))
    return recv.reshape(d * nxl, ny // d, m)


def transpose_yx(local: torch.Tensor, mesh, axis_name: str = runtime.SPACE_AXIS) -> torch.Tensor:
    """(nx, ny/d, m) y-slab -> (nx/d, ny, m) x-slab over the ``axis_name``
    group of ``mesh``, the inverse of ``transpose_xy``: one
    ``all_to_all_single``. The x rows bound for rank j are already the
    major block j; after the exchange the source rank's y columns are
    moved next to its x rows' minor index, which is global y order.
    Complex tensors travel as their real views."""
    d = runtime.axis_size(mesh, axis_name)
    nx, nyl, m = (int(s) for s in local.shape)
    if nx % d:
        raise ValueError(f"x extent {nx} does not split over {d} ranks")
    send = local.contiguous()
    recv = torch.empty_like(send)
    if send.is_complex():
        dist.all_to_all_single(
            torch.view_as_real(recv), torch.view_as_real(send), group=mesh.get_group(axis_name)
        )
    else:
        dist.all_to_all_single(recv, send, group=mesh.get_group(axis_name))
    return recv.reshape(d, nx // d, nyl, m).transpose(0, 1).reshape(nx // d, d * nyl, m)


def pencil_rfft(x_local: torch.Tensor, mesh, axis_name: str = runtime.SPACE_AXIS) -> torch.Tensor:
    """The rank's y-slab (nx, ny/d, nz//2+1) of the normalized
    (``norm="forward"``) real transform of a volume slab-sharded along x:
    rfft2 over (y, z), the x <-> y exchange, the FFT over x."""
    w = torch.fft.rfft2(x_local, dim=(1, 2), norm="forward")
    return torch.fft.fft(transpose_xy(w, mesh, axis_name), dim=0, norm="forward")


def pencil_irfft(y_hat: torch.Tensor, full_shape, mesh,
                 axis_name: str = runtime.SPACE_AXIS) -> torch.Tensor:
    """The rank's x-slab (nx/d, ny, nz) of the volume whose normalized
    (``norm="forward"``) half-spectrum has the y-slab ``y_hat`` (nx, ny/d,
    nz//2+1) here: the inverse of ``pencil_rfft``. The inverse FFT over
    x, the y <-> x exchange, the inverse real transform over (y, z) onto
    the volume's (ny, nz); neither inverse scales, as the forward
    transform carried the whole 1/N."""
    _nx, ny, nz = (int(s) for s in full_shape)
    w = transpose_yx(torch.fft.ifft(y_hat, dim=0, norm="forward"), mesh, axis_name)
    return torch.fft.irfft2(w, s=(ny, nz), dim=(1, 2), norm="forward")


def pfft3(x_local: torch.Tensor, mesh=None, axis_name: str = runtime.SPACE_AXIS) -> torch.Tensor:
    """Forward unnormalized 3D FFT of a volume slab-sharded along x.

    ``x_local`` is this rank's x-slab; the result is its y-slab (nx,
    ny/d, nz) in unshifted k order. With no mesh, a one-rank space axis,
    or a volume the placement rule leaves whole (ny not a multiple of
    the space axis: ``x_local`` is then the whole volume), it is
    ``torch.fft.fftn``, as in fava_tpu.
    """
    mesh = mesh if mesh is not None else runtime.get_mesh()
    d = runtime.axis_size(mesh, axis_name)
    if mesh is None or d == 1 or x_local.shape[1] % d:
        return torch.fft.fftn(x_local)
    local = torch.fft.fftn(x_local, dim=(1, 2))
    return torch.fft.fft(transpose_xy(local, mesh, axis_name), dim=0)


def _wavenumbers(n: int, dtype, device=None) -> torch.Tensor:
    """Integer wavenumbers in unshifted FFT order: [0..n/2-1, -n/2..-1]
    (the reference's fftshift + linspace grid on even n)."""
    k = torch.arange(n, device=device)
    return torch.where(k <= (n - 1) // 2, k, k - n).to(dtype)
