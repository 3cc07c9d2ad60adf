"""FLASH uniform-grid mesh (single-block ``hdf5_uniform_`` files).

Counterpart of fava_tpu/mesh/flash_uniform.py, in-core only: field
reads onto the device (the metadata ``load`` is FLASH's), ``from_arrays``,
the flagship analysis, the kinetic-energy and scalar spectra, and the
PDFs and conditional statistics of pipeline stage 4. ``reynolds_stress``,
``favre_profiles``, the slice profiles, ``mass_sum`` and the volume
averages are FLASH's: on one block profiled along x the profiles take
the uniform fast case (K1/K2). The streamed out-of-core path is ROADMAP
A10; the other uniform-grid analyses are ROADMAP A7/A8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from fava_tpu_torch.io import flash_file
from fava_tpu_torch.mesh.flash_amr import FLASH
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.ops import spectra as spectra_ops
from fava_tpu_torch.ops import volume as volume_ops
from fava_tpu_torch.utils import field_dtype, timer


@Model.register_mesh()
class FlashUniform(FLASH):
    """Uniform-grid FLASH mesh; field data is a single 3D volume on the device."""

    @classmethod
    def from_arrays(
        cls,
        fields: Dict[str, object],
        domain_bounds: Optional[np.ndarray] = None,
        time: float = 0.0,
        device="cuda",
    ) -> "FlashUniform":
        """In-memory uniform mesh from plain arrays — no FLASH file.

        ``fields`` maps FLASH-style names (dens/velx/vely/velz/...) to
        same-shaped 1D/2D/3D numpy arrays or tensors; they are copied to
        ``device`` in its field dtype. ``domain_bounds`` is (ndim, 2)
        physical bounds (unit box default).
        """
        mesh = cls(None, device=device)
        shapes = {tuple(int(s) for s in np.shape(v)) for v in fields.values()}
        if not fields or len(shapes) != 1:
            raise ValueError(f"fields must share one shape, got {sorted(shapes)}")
        shape = shapes.pop()
        nd = len(shape)
        if nd not in (1, 2, 3):
            raise ValueError(f"fields must be 1D/2D/3D, got {nd}D")
        full = shape + (1,) * (3 - nd)
        b = np.asarray(
            domain_bounds if domain_bounds is not None else [[0.0, 1.0]] * nd,
            dtype=np.float64,
        )
        if b.shape != (nd, 2):
            raise ValueError(f"domain_bounds must be ({nd}, 2), got {b.shape}")
        bounds3 = np.concatenate([b, np.tile([[0.0, 1.0]], (3 - nd, 1))])

        mesh.scalars = {
            "integer": {
                "dimensionality": nd,
                "nxb": full[0],
                "nyb": full[1],
                "nzb": full[2],
                "total blocks": 1,
            },
            "real": {"time": float(time)},
            "string": {"geometry": "cartesian"},
            "logical": {},
        }
        mesh.runtime_parameters = {
            "integer": {"nblockx": 1, "nblocky": 1, "nblockz": 1},
            "real": {
                f"{a}{mm}": float(bounds3[i, j])
                for i, a in enumerate("xyz")
                for j, mm in enumerate(("min", "max"))
            },
            "string": {},
            "logical": {},
        }
        mesh._set_integers()
        mesh._set_reals()
        mesh.fields = list(fields)
        mesh.block_bounds = bounds3[None]
        mesh.node_type = np.ones(1, dtype=np.int64)
        mesh.refine_level = np.ones(1, dtype=np.int64)
        mesh.coordinates = 0.5 * bounds3.sum(axis=1)[None]
        dtype = field_dtype(mesh.device)
        mesh._data = {
            name: torch.as_tensor(v, dtype=dtype, device=mesh.device).reshape(full).contiguous()
            for name, v in fields.items()
        }
        mesh._loaded = True
        return mesh

    def _read_field(self, handle, name: str) -> None:
        vol = flash_file.read_field(handle, name, self.device, field_dtype(self.device))
        # Uniform files hold one block; store the bare 3D volume.
        if vol.ndim == 4 and vol.shape[0] == 1:
            vol = vol[0]
        self._data[name] = vol

    def _volume(self, name: str) -> torch.Tensor:
        d = self.data(name)
        if d is None:
            raise KeyError(name)
        if d.ndim == 4:
            d = d[0]
        return d

    def _check_fits(self, shape) -> None:
        """Raise NotImplementedError when the in-core step would not fit
        the card's free memory (the streamed path is ROADMAP A10)."""
        if self.device.type != "cuda":
            return
        item = torch.finfo(field_dtype(self.device)).bits // 8
        nx, ny, nz = shape
        ntot = nx * ny * nz
        nhalf = nx * ny * (nz // 2 + 1)
        resident = sum(t.numel() * t.element_size() for t in self._data.values())
        # 4 fields + 3 complex half-spectra + ~6 half-size power and
        # complex projection temporaries + one full-size product.
        need = 4 * item * ntot - resident + 3 * 2 * item * nhalf + 6 * 2 * item * nhalf + item * ntot
        free, _total = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        if need > 0.9 * free:
            raise NotImplementedError(
                f"flagship_analysis of a {shape} volume needs ~{need / 1e9:.1f} GB but "
                f"{free / 1e9:.1f} GB is free on {self.device}; the streamed "
                "out-of-core path is not ported yet (ROADMAP A10)"
            )

    @timer
    def flagship_analysis(self, streamed: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """Fused spectra + Reynolds/Favre x-profiles of the in-core volume.

        ``streamed=True``, or a volume that does not fit the card's free
        memory under ``streamed=None``, raises NotImplementedError: the
        out-of-core path is ROADMAP A10.
        """
        from fava_tpu_torch import flagship

        if self.ndim != 3:
            raise ValueError("flagship_analysis requires a 3D dataset")
        shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
        if streamed:
            raise NotImplementedError(
                "streamed=True: the out-of-core flagship path is not ported yet (ROADMAP A10)"
            )
        if streamed is None:
            self._check_fits(shape)
        vols = [self._volume(name) for name in ("dens", "velx", "vely", "velz")]
        out = flagship.uniform_analysis_step(*vols)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @timer
    def kinetic_energy_spectra(self) -> Dict[str, np.ndarray]:
        """KE spectra (reference: FlashUniform.py:229-304)."""
        vels = [self._volume(f"vel{a}") for a in "xyz"[: self.ndim]]
        return spectra_ops.kinetic_energy_spectra(self._volume("dens"), vels, ndim=self.ndim)

    @timer
    def scalar_spectra(self, field: str) -> Dict[str, Dict[str, np.ndarray]]:
        """Power spectrum of one scalar field (density/flame/...): the KE
        spectra's transform, binning convention and integral factor, so
        slopes compare directly."""
        return {field: spectra_ops.scalar_spectrum(self._volume(field), ndim=self.ndim)}

    def _scalar_volume(self, name: str) -> torch.Tensor:
        """Scalar field volume squeezed to ``ndim`` axes (2D datasets carry
        (nx, ny, 1) volumes), so it pairs cell by cell with the others."""
        v = self._volume(name)
        nd = self.ndim
        if v.ndim > nd:
            if not all(s == 1 for s in v.shape[nd:]):
                raise ValueError(
                    f"dataset claims {nd}D but field {name!r} has "
                    f"non-singleton trailing axes: {tuple(v.shape)}"
                )
            v = v.reshape(v.shape[:nd])
        return v

    def mass_fraction(self, masks: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """Total + per-mask mass (reference: FlashUniform.py:449-458)."""
        return volume_ops.mass_sum(self._volume("dens"), self.cell_volume_min, masks)

    def _uniform_pdf_weights(self, weight: Optional[str]):
        """Uniform cells share one volume, so "volume" weighting is the
        unweighted path (None); "mass" weights by dens."""
        if weight in (None, "volume"):
            return None
        if weight == "mass":
            return self._scalar_volume("dens")
        raise ValueError(f"Unknown pdf weight {weight}")

    @timer
    def pdf1d(self, field: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted 1D PDF of a field."""
        return volume_ops.pdf1d(
            self._scalar_volume(field), weights=self._uniform_pdf_weights(weight), **kwargs
        )

    @timer
    def pdf2d(self, field1: str, field2: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted joint PDF of two fields (the joint-histogram kernel)."""
        return volume_ops.pdf2d(
            self._scalar_volume(field1),
            self._scalar_volume(field2),
            weights=self._uniform_pdf_weights(weight),
            **kwargs,
        )

    @timer
    def binned_statistic(
        self, xfield: str, yfield: str, weight: Optional[str] = "volume", **kwargs
    ) -> Dict[str, Any]:
        """Per-bin count/mean/std of ``yfield`` conditioned on ``xfield``;
        weight="volume" is the exact unweighted path, "mass" weights by
        dens."""
        return volume_ops.binned_statistic(
            self._scalar_volume(xfield),
            self._scalar_volume(yfield),
            weights=self._uniform_pdf_weights(weight),
            **kwargs,
        )

    @timer
    def density_pdf(self, weight: Optional[str] = "volume", **kwargs) -> Dict[str, Any]:
        """Lognormality diagnostics of s = ln(rho/<rho>) (ops/volume.density_pdf)."""
        return volume_ops.density_pdf(
            self._scalar_volume("dens"), weights=self._uniform_pdf_weights(weight), **kwargs
        )
