"""FLASH uniform-grid mesh (single-block ``hdf5_uniform_`` files).

Counterpart of fava_tpu/mesh/flash_uniform.py, single device: field
reads onto the device (the metadata ``load`` is FLASH's), ``from_arrays``,
the flagship analysis (in core, or streamed from the file by
``ops/outofcore.py`` when the volume does not fit the card), the
kinetic-energy and scalar spectra, the PDFs and conditional statistics
of pipeline stage 4, the fractal dimension, and the velocity structure
functions with their scaling exponents and increment PDFs, the flame
surface density and the line-of-sight projection.
Under an active device mesh (``parallel/``) whose space axis shards the
volume (the placement rule, ``parallel.runtime.shards_volume``), ``load``
and ``from_arrays`` keep only this rank's x-slab of each field (``load``
reads the slab straight from the file). These analyses then run on the
slab and join by halos, packed all_reduces, all_gathers of row
statistics or coarse masks and the pencil transform and its inverse,
never of a whole field (ROADMAP A11a, A11d, A11e, A11f):
``kinetic_energy_spectra``, ``flagship_analysis``, ``scalar_spectra``,
``fractal_dimension``, ``structure_functions`` and
``structure_function_exponents``, ``velocity_increment_pdfs``,
``turbulence_summary``, ``velocity_gradient_statistics``,
``gradient_invariant_pdfs``, the enstrophy, helicity, decomposed,
anisotropic and transfer spectra, ``pdf1d``, ``pdf2d``,
``binned_statistic``, ``density_pdf``, ``mass_fraction``,
``filtered_kinetic_energy_flux``, ``two_point_correlation``,
``velocity_correlations``, ``helmholtz_decomposition``, ``vorticity``
and ``dilatation`` (the last three return whole numpy fields, which they
build on the host one slab at a time, ``SpaceRanks.host_volume``),
``flame_surface`` (one halo plane along x), ``projection`` (one SUM
along x, else the map's rows gathered), and FLASH's profiles, volume
sums, PDFs and point sampling (mesh/flash_amr.py, which a sharded
``from_amr`` shares). Only ``data()`` gets the whole volume (one
all_gather on the space group); ``save`` gathers the slabs and writes
from rank 0, and ``from_amr`` gathers before it collapses. The streamed
paths read the file whole on every rank.
``reynolds_stress``, ``favre_profiles``, the slice profiles, ``mass_sum``
and the volume averages are FLASH's: on one block profiled along x the
profiles take the uniform fast case (K1/K2). The velocity diagnostics
(Helmholtz parts, vorticity, dilatation, the enstrophy, helicity,
transfer, decomposed and anisotropic spectra, the turbulence summary)
and the gradient statistics and Q-R PDF run in core (ops/velocity.py,
ops/gradients.py), as do the filtered kinetic-energy flux
(ops/coarse_grain.py) and the two-point and velocity correlations
(ops/twopoint.py). The summary, the gradient statistics and both
correlations also stream from the file (``streamed=True``,
ops/outofcore.py) for volumes the card cannot hold.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from fava_tpu_torch.io import flash_file, h5lite
from fava_tpu_torch.mesh.flash_amr import FLASH
from fava_tpu_torch.models.model import Model
from fava_tpu_torch.ops import coarse_grain as cg_ops
from fava_tpu_torch.ops import flame as flame_ops
from fava_tpu_torch.ops import fractal as fractal_ops
from fava_tpu_torch.ops import gradients as grad_ops
from fava_tpu_torch.ops import outofcore
from fava_tpu_torch.ops import projection as projection_ops
from fava_tpu_torch.ops import spectra as spectra_ops
from fava_tpu_torch.ops import structure as structure_ops
from fava_tpu_torch.ops import twopoint as tp_ops
from fava_tpu_torch.ops import velocity as vel_ops
from fava_tpu_torch.ops import volume as volume_ops
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import field_dtype, timer
from fava_tpu_torch.utils.profiling import SPAN_SYNC_OUTPUTS, annotate


def streams_out_of_core(shape, dtype: torch.dtype, free_bytes: float, resident_bytes: int = 0) -> bool:
    """Whether the in-core flagship step of a ``shape`` volume of
    ``dtype`` fields would not fit ``free_bytes`` of card memory, with
    ``resident_bytes`` of its fields already there: the auto-dispatch
    rule of ``flagship_analysis(streamed=None)``. It counts 4 fields, 3
    complex half-spectra, ~6 half-size complex power and projection
    temporaries and one full-size product, against 90% of the free
    memory. On an 80 GB card 1024^3 float32 (~60 GB) runs in core and
    1280^3 (~118 GB) streams."""
    item = torch.finfo(dtype).bits // 8
    nx, ny, nz = (int(s) for s in shape)
    ntot = nx * ny * nz
    nhalf = nx * ny * (nz // 2 + 1)
    need = 5 * item * ntot - resident_bytes + 9 * 2 * item * nhalf
    return need > 0.9 * free_bytes


@Model.register_mesh()
class FlashUniform(FLASH):
    """Uniform-grid FLASH mesh; field data is a single 3D volume on the
    device, or this rank's x-slab of it under a mesh that shards it."""

    @classmethod
    def is_this_your_mesh(cls, filename: str | Path, *args, **kwargs) -> bool:
        return "hdf5_uniform_" in str(filename)

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
        mesh._place()
        dtype = field_dtype(mesh.device)
        mesh._data = {}
        for name, v in fields.items():
            src = torch.as_tensor(v).reshape(full)
            if mesh._dmesh is not None:
                src = runtime.shard_volume(src, mesh._dmesh)
            mesh._data[name] = src.to(device=mesh.device, dtype=dtype).contiguous()
        mesh._loaded = True
        return mesh

    def load(self) -> None:
        super().load()
        self._place()

    def _place(self) -> None:
        """The placement rule at load: the active mesh shards a 3D volume
        when both nx and ny divide its space axis."""
        mesh = runtime.get_mesh()
        shape = (self.nxb, self.nyb, self.nzb)
        self._dmesh = mesh if self.ndim == 3 and runtime.shards_volume(shape, mesh) else None

    def _read_field(self, handle, name: str) -> None:
        dtype = field_dtype(self.device)
        if self._dmesh is not None:
            # This rank's rows only, from the stored (nz, ny, nx) layout,
            # swapped on the device as read_field does.
            lo, hi = runtime.slab_rows(self.nxb, self._dmesh)
            stored = np.swapaxes(flash_file.read_field_slab(handle, name, lo, hi), 0, 2)
            raw = torch.from_numpy(np.ascontiguousarray(stored))
            self._data[name] = raw.to(device=self.device, dtype=dtype).transpose(0, 2).contiguous()
            return
        vol = flash_file.read_field(handle, name, self.device, dtype)
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

    def _local_volume(self, name: str) -> torch.Tensor:
        """A field as this rank holds it: its x-slab under a sharding
        mesh, else the whole volume squeezed to ``ndim`` axes."""
        return self._slab(name) if self._dmesh is not None else self._scalar_volume(name)

    def _local_velocities(self):
        return [self._local_volume(f"vel{a}") for a in "xyz"[: self.ndim]]

    def _streams(self, shape) -> bool:
        """``streams_out_of_core`` against this card's free memory (the
        CPU never streams on its own)."""
        if self.device.type != "cuda":
            return False
        free, _total = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        resident = sum(t.numel() * t.element_size() for t in self._data.values())
        if self._dmesh is not None:
            shape = (shape[0] // runtime.space_axis_size(self._dmesh),) + tuple(shape[1:])
        return streams_out_of_core(shape, field_dtype(self.device), free, resident)

    def _domain_lengths(self):
        b = np.asarray(self.domain_bounds, dtype=np.float64)
        return tuple(float(b[i, 1] - b[i, 0]) for i in range(self.ndim))

    def _streamed_loader(self, check_fields: bool = False):
        """Host x-slab loader of this mesh's file for the out-of-core paths.
        ``check_fields`` raises KeyError for a field absent from the file
        (the streamed summary's gamc fallback relies on it)."""
        if self._filename is None:
            raise ValueError(
                "streamed paths need a file-backed mesh; from_arrays data "
                "is fully resident — use the in-core analyses"
            )
        path = self._filename
        fields = set(self.fields)

        def loader(name: str, x0: int, x1: int) -> np.ndarray:
            if check_fields and name not in fields:
                raise KeyError(name)
            with h5lite.File(path, "r") as f:
                return flash_file.read_field_slab(f, name, x0, x1)

        return loader

    @staticmethod
    def _largest_divisor(n: int, target) -> int:
        # The largest divisor of n NOT EXCEEDING the request: the slab and
        # chunk knobs exist to shrink memory, so never round up.
        target = max(1, min(int(target or 64), n))
        return next(c for c in range(target, 0, -1) if n % c == 0)

    @staticmethod
    def _reject_stream_knobs(**knobs):
        """Streaming knobs passed with streamed=False would be silently
        ignored by the in-core path (a caller asking for the bf16 wire
        must not silently get the full-precision in-core run)."""
        ignored = sorted(k for k, (v, default) in knobs.items() if v is not None and v != default)
        if ignored:
            raise TypeError(
                f"{ignored} only apply to the streamed out-of-core path; "
                "pass streamed=True (these knobs have no effect in-core)"
            )

    @timer
    def flagship_analysis(
        self,
        streamed: Optional[bool] = None,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype: Optional[torch.dtype] = None,
        prefetch_depth: int = 2,
    ) -> Dict[str, np.ndarray]:
        """Fused spectra + Reynolds/Favre x-profiles.

        In core (``flagship.uniform_analysis_step``) when the volume fits
        the card, or streamed from the file by
        ``ops/outofcore.streamed_uniform_analysis`` when it does not:
        ``streamed=None`` decides by ``streams_out_of_core`` against the
        card's free memory. ``slab_rows``/``chunk_rows`` round down to
        divisors of nx (64 when None); ``wire_dtype`` (e.g.
        ``torch.bfloat16``) casts the slabs on the host and widens them
        on the card.
        """
        from fava_tpu_torch import flagship

        if self.ndim != 3:
            raise ValueError("flagship_analysis requires a 3D dataset")
        shape = tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))
        if streamed is False:
            # An explicit in-core request; under streamed=None the knobs
            # are legitimate in case the volume streams.
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
        if streamed is None:
            streamed = self._streams(shape)
        if streamed:
            return outofcore.streamed_uniform_analysis(
                self._streamed_loader(),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                device=self.device,
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )
        names = ("dens", "velx", "vely", "velz")
        if self._dmesh is not None:
            out = flagship.uniform_analysis_step(*map(self._slab, names), mesh=self._dmesh)
        else:
            out = flagship.uniform_analysis_step(*map(self._volume, names))
        with annotate(SPAN_SYNC_OUTPUTS):
            return {k: v.cpu().numpy() for k, v in out.items()}

    @timer
    def kinetic_energy_spectra(self) -> Dict[str, np.ndarray]:
        """KE spectra (reference: FlashUniform.py:229-304); sharded over
        the mesh the volume is placed on."""
        if self._dmesh is not None:
            vels = [self._slab(f"vel{a}") for a in "xyz"]
            return spectra_ops.kinetic_energy_spectra(
                self._slab("dens"), vels, ndim=3, mesh=self._dmesh
            )
        vels = [self._volume(f"vel{a}") for a in "xyz"[: self.ndim]]
        return spectra_ops.kinetic_energy_spectra(self._volume("dens"), vels, ndim=self.ndim)

    @timer
    def scalar_spectra(self, field: str) -> Dict[str, Dict[str, np.ndarray]]:
        """Power spectrum of one scalar field (density/flame/...): the KE
        spectra's transform, binning convention and integral factor, so
        slopes compare directly."""
        if self._dmesh is not None:
            return {field: spectra_ops.scalar_spectrum(self._slab(field), ndim=3,
                                                       mesh=self._dmesh)}
        return {field: spectra_ops.scalar_spectrum(self._volume(field), ndim=self.ndim)}

    @timer
    def fractal_dimension(self, field: str, contours=0.5) -> Dict[str, Any]:
        """Box-counting dimension (reference: FlashUniform.py:85-227)."""
        vol = self._slab(field) if self._dmesh is not None else self._volume(field)
        return {field: fractal_ops.fractal_dimension(vol, contours, mesh=self._dmesh)}

    @timer
    def structure_functions(
        self,
        num_seps: int = 100,
        num_points: int = 10000,
        sep_bounds: Optional[Sequence[float]] = None,
        log_scale: bool = True,
        anisotropic: bool = False,
        seed: int = 0,
        resample_per_order: bool = True,
        **kwargs,
    ) -> Dict[str, Any]:
        """Velocity structure functions (reference: FlashUniform.py:306-447).

        Accepts the reference settings-file spelling ``anistropic`` too.
        ``sep_bounds`` defaults to the resolvable separation range;
        ``resample_per_order=False`` evaluates all ten orders on one
        shared pair draw (ops/structure.structure_functions). 2D datasets
        sample their (nx, ny) planes (fava_tpu's mesh passes the
        (nx, ny, 1) volumes, which its 2D gather does not take).
        """
        if "anistropic" in kwargs:
            anisotropic = kwargs.pop("anistropic")
        if kwargs:
            raise TypeError(f"structure_functions got unexpected keyword arguments {sorted(kwargs)}")
        return structure_ops.structure_functions(
            self._local_velocities(),
            domain_bounds=self.domain_bounds,
            mesh=self._dmesh,
            num_seps=num_seps,
            num_points=num_points,
            sep_bounds=tuple(sep_bounds) if sep_bounds is not None else None,
            log_scale=log_scale,
            anisotropic=anisotropic,
            seed=seed,
            resample_per_order=resample_per_order,
        )

    @timer
    def structure_function_exponents(
        self,
        vsfs: Optional[Dict[str, Any]] = None,
        reference_order: int = 3,
        fit_range: Optional[Sequence[float]] = None,
        ess: bool = True,
        **sf_kwargs,
    ) -> Dict[str, Any]:
        """Intermittency scaling exponents zeta_p, ESS by default (beyond
        the reference) of ``vsfs``, a :meth:`structure_functions` result,
        or of one computed here with ``**sf_kwargs``."""
        if vsfs is None:
            vsfs = self.structure_functions(**sf_kwargs)
        return structure_ops.scaling_exponents(
            vsfs, reference_order=reference_order, fit_range=fit_range, ess=ess
        )

    @timer
    def velocity_increment_pdfs(
        self,
        num_seps: int = 8,
        num_points: int = 65536,
        sep_bounds: Optional[Sequence[float]] = None,
        log_scale: bool = True,
        nbins: int = 101,
        nsigma: float = 10.0,
        anisotropic: bool = False,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """PDFs of signed velocity increments vs separation (beyond the
        reference; ops/structure.velocity_increment_pdfs)."""
        return structure_ops.velocity_increment_pdfs(
            self._local_velocities(),
            domain_bounds=self.domain_bounds,
            mesh=self._dmesh,
            num_seps=num_seps,
            num_points=num_points,
            sep_bounds=tuple(sep_bounds) if sep_bounds is not None else None,
            log_scale=log_scale,
            nbins=nbins,
            nsigma=nsigma,
            anisotropic=anisotropic,
            seed=seed,
        )

    def _shape3(self, what: str):
        """The (nx, ny, nz) of a 3D dataset, which every streamed path needs."""
        if self.ndim != 3:
            raise ValueError(f"streamed {what} requires a 3D dataset")
        return tuple(int(n) for n in (self.nxb, self.nyb, self.nzb))

    def _host_field(self, t: torch.Tensor) -> np.ndarray:
        """A field an analysis returns as this rank holds it (its x-slab
        under a sharding mesh) as the whole numpy volume, the same on
        every rank (``SpaceRanks.host_volume``)."""
        return runtime.SpaceRanks(self._dmesh).host_volume([t])

    @timer
    def helmholtz_decomposition(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Solenoidal/compressive velocity split by spectral projection on
        this domain's physical wavenumber grid (ops/velocity.py). Under a
        sharding mesh the split runs on the rank's slab (the pencil
        transform and its inverse) and each of the six fields is built on
        the host slab by slab: every rank returns the same whole arrays,
        which take the host memory of six volumes on each rank, and the
        card holds one more slab while they are built."""
        out = vel_ops.helmholtz_decompose(*self._local_velocities(), lengths=self._domain_lengths(),
                                          mesh=self._dmesh)
        return {part: {name: self._host_field(v) for name, v in comps.items()}
                for part, comps in out.items()}

    @timer
    def vorticity(self) -> Dict[str, np.ndarray]:
        """Vorticity by spectral differentiation (2D: the scalar
        out-of-plane component only). Under a sharding mesh, rank-local
        and built on the host slab by slab as
        :meth:`helmholtz_decomposition` (three volumes on each rank's
        host)."""
        out = vel_ops.vorticity(*self._local_velocities(), lengths=self._domain_lengths(),
                                mesh=self._dmesh)
        if self.ndim == 2:
            return {"vortz": self._host_field(out)}
        return {k: self._host_field(v) for k, v in zip(("vortx", "vorty", "vortz"), out)}

    @timer
    def dilatation(self) -> Dict[str, np.ndarray]:
        """Dilatation (velocity divergence) by spectral differentiation.
        Under a sharding mesh, rank-local and built on the host slab by
        slab as :meth:`helmholtz_decomposition` (one volume on each
        rank's host)."""
        d = vel_ops.dilatation(*self._local_velocities(), lengths=self._domain_lengths(),
                               mesh=self._dmesh)
        return {"dilatation": self._host_field(d)}

    @timer
    def enstrophy_spectra(self) -> Dict[str, np.ndarray]:
        """Shell-binned enstrophy spectrum (KE-spectra conventions)."""
        return vel_ops.enstrophy_spectrum(*self._local_velocities(), lengths=self._domain_lengths(),
                                          mesh=self._dmesh)

    @timer
    def helicity_spectra(self) -> Dict[str, np.ndarray]:
        """Shell-binned signed helicity spectrum (3D only: helicity
        vanishes identically in in-plane 2D flows)."""
        if self.ndim != 3:
            raise ValueError("helicity vanishes identically in 2D flows (3D datasets only)")
        return vel_ops.helicity_spectrum(*self._local_velocities(), lengths=self._domain_lengths(),
                                         mesh=self._dmesh)

    @timer
    def velocity_gradient_statistics(
        self,
        boundary: str = "periodic",
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        wire_dtype: Optional[torch.dtype] = None,
        prefetch_depth: int = 2,
    ) -> Dict[str, Any]:
        """Velocity-gradient tensor statistics: central-difference g_ij
        moments to fourth order, derivative skewness and flatness,
        pseudo-dissipation, enstrophy and dilatation mean squares, Taylor
        microscales (ops/gradients.py). ``boundary="interior"`` drops the
        periodic wrap (windowed extracts such as the flame windows).
        ``streamed=True`` takes the out-of-core halo-slab path from the
        file (3D, periodic only; ops/outofcore.streamed_gradient_stats);
        ``slab_rows`` rounds down to a divisor of nx (64 when None)."""
        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
            return grad_ops.velocity_gradient_statistics(
                *self._local_velocities(), lengths=self._domain_lengths(), boundary=boundary,
                mesh=self._dmesh,
            )
        shape = self._shape3("gradient statistics")
        if boundary != "periodic":
            raise ValueError(
                "streamed gradient statistics are periodic-only (windowed "
                "interior extracts fit in core by construction)"
            )
        return outofcore.streamed_gradient_stats(
            self._streamed_loader(),
            shape,
            slab_rows=self._largest_divisor(shape[0], slab_rows),
            device=self.device,
            lengths=self._domain_lengths(),
            wire_dtype=wire_dtype,
            prefetch_depth=prefetch_depth,
        )

    @timer
    def gradient_invariant_pdfs(
        self, nbins=(100, 100), qr_range: float = 8.0, boundary: str = "periodic"
    ) -> Dict[str, Any]:
        """Joint PDF of the velocity-gradient invariants (Q, R) on axes
        normalised by Q_w = <omega^2>/4, exact counts through the
        joint-histogram kernel (ops/gradients.gradient_invariant_pdfs).
        3D datasets only."""
        return grad_ops.gradient_invariant_pdfs(
            *self._local_velocities(), lengths=self._domain_lengths(), nbins=nbins,
            qr_range=qr_range, boundary=boundary, mesh=self._dmesh,
        )

    @timer
    def decomposed_kinetic_energy_spectra(self, weighted: bool = False) -> Dict[str, np.ndarray]:
        """Solenoidal/compressive split of the KE spectrum (the Helmholtz
        projection in k-space: total == solenoidal + compressive shell by
        shell). ``weighted=True`` transforms sqrt(rho) u
        (ops/velocity.decomposed_ke_spectra)."""
        return vel_ops.decomposed_ke_spectra(
            *self._local_velocities(),
            dens=self._local_volume("dens") if weighted else None,
            lengths=self._domain_lengths(),
            mesh=self._dmesh,
        )

    @timer
    def turbulence_summary(
        self,
        gamma: float = 5.0 / 3.0,
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype: Optional[torch.dtype] = None,
        prefetch_depth: int = 2,
    ) -> Dict[str, float]:
        """One-call scalar turbulence report (ops/velocity.turbulence_summary):
        u_rms and KE, integral and Taylor scales, the solenoidal and
        compressive energy fractions, vorticity and dilatation rms, the
        log-density moments, and the Mach statistics when this file
        carries ``pres`` (its per-cell ``gamc`` over the scalar ``gamma``
        when present). ``streamed=True`` takes the out-of-core x-slab path
        from the file (3D; ops/outofcore.streamed_turbulence_summary);
        ``slab_rows``/``chunk_rows`` round down to divisors of nx."""
        if streamed:
            shape = self._shape3("turbulence_summary")
            return outofcore.streamed_turbulence_summary(
                self._streamed_loader(check_fields=True),
                shape,
                slab_rows=self._largest_divisor(shape[0], slab_rows),
                chunk_rows=self._largest_divisor(shape[0], chunk_rows),
                device=self.device,
                gamma=gamma,
                lengths=self._domain_lengths(),
                with_mach="pres" in self.fields,
                wire_dtype=wire_dtype,
                prefetch_depth=prefetch_depth,
            )
        self._reject_stream_knobs(
            slab_rows=(slab_rows, None),
            chunk_rows=(chunk_rows, None),
            wire_dtype=(wire_dtype, None),
            prefetch_depth=(prefetch_depth, 2),
        )

        def opt(name):
            return None if self._local_data(name) is None else self._local_volume(name)

        pres = opt("pres")
        gamc = opt("gamc") if pres is not None else None
        return vel_ops.turbulence_summary(
            *self._local_velocities(),
            dens=opt("dens"),
            pres=pres,
            gamma=gamc if gamc is not None else gamma,
            lengths=self._domain_lengths(),
            mesh=self._dmesh,
        )

    @timer
    def anisotropic_kinetic_energy_spectra(self, axis: int = 0) -> Dict[str, np.ndarray]:
        """Axis-resolved KE spectra relative to ``axis`` (default x, the
        flame-propagation axis): parallel and perpendicular sums, each
        split into axial and transverse components, energy-exact
        (ops/velocity.anisotropic_ke_spectra)."""
        return vel_ops.anisotropic_ke_spectra(
            *self._local_velocities(), axis=axis, lengths=self._domain_lengths(), mesh=self._dmesh
        )

    @timer
    def transfer_spectra(self, dealias: bool = False) -> Dict[str, np.ndarray]:
        """Nonlinear kinetic-energy transfer T(k) and flux Π(k), shell
        sums (ops/velocity.transfer_spectrum)."""
        return vel_ops.transfer_spectrum(
            *self._local_velocities(), lengths=self._domain_lengths(), dealias=dealias,
            mesh=self._dmesh,
        )

    @timer
    def filtered_kinetic_energy_flux(
        self,
        cutoffs: Sequence[float] = (4.0, 8.0, 16.0),
        kernel: str = "gaussian",
        with_pressure: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Favre-filtered SGS kinetic-energy flux sweep Pi_l: mean/RMS
        deformation work across a list of filter cutoffs, density-weighted,
        plus the baropycnal work when ``with_pressure`` and a ``pres``
        field is on file (ops/coarse_grain.py; rank-local under a sharding
        mesh)."""
        pres = None
        if with_pressure:
            if "pres" not in self.fields:
                raise KeyError("with_pressure=True but this file carries no 'pres' field")
            pres = self._local_volume("pres")
        return cg_ops.filtered_ke_flux(
            *self._local_velocities(),
            dens=self._local_volume("dens"),
            pres=pres,
            cutoffs=tuple(float(k) for k in cutoffs),
            kernel=kernel,
            lengths=self._domain_lengths(),
            mesh=self._dmesh,
        )

    @timer
    def two_point_correlation(
        self,
        field: str = "dens",
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype: Optional[torch.dtype] = None,
        prefetch_depth: int = 2,
        **kwargs,
    ) -> Dict[str, Any]:
        """Scalar two-point autocorrelation R(r) = <f'(x)f'(x+r)>/var: the
        shell-averaged isotropic curve and per-axis lines with integral
        length scales (ops/twopoint.two_point_correlation; ``nbins`` and
        the other keywords go there; rank-local under a sharding mesh).
        ``streamed=True`` takes the out-of-core path for 3D volumes: the
        per-axis lines and integral scales only, the shell curve needing
        the whole correlation volume (ops/outofcore.streamed_two_point_lines)."""
        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
            return tp_ops.two_point_correlation(
                self._local_volume(field), lengths=self._domain_lengths(), mesh=self._dmesh,
                **kwargs
            )
        if kwargs:
            # silently dropping e.g. nbins= would return a result that
            # ignored the request: the streamed path has no shell curve
            raise TypeError(
                f"{sorted(kwargs)} not supported with streamed=True: the "
                "shell curve (and its nbins) needs the full correlation "
                "volume; the streamed path returns per-axis lines only"
            )
        shape = self._shape3("two_point_correlation")
        return outofcore.streamed_two_point_lines(
            self._streamed_loader(),
            shape,
            field,
            slab_rows=self._largest_divisor(shape[0], slab_rows),
            chunk_rows=self._largest_divisor(shape[0], chunk_rows),
            device=self.device,
            lengths=self._domain_lengths(),
            wire_dtype=wire_dtype,
            prefetch_depth=prefetch_depth,
        )

    @timer
    def velocity_correlations(
        self,
        streamed: bool = False,
        slab_rows: Optional[int] = None,
        chunk_rows: Optional[int] = None,
        wire_dtype: Optional[torch.dtype] = None,
        prefetch_depth: int = 2,
    ) -> Dict[str, Any]:
        """Karman-Howarth longitudinal f(r) and transverse g(r) velocity
        correlations per axis with the L11/L22 integral scales and the
        isotropy ratio L11/(2 L22) (ops/twopoint.velocity_correlations;
        rank-local under a sharding mesh).
        ``streamed=True`` takes the out-of-core x-slab path for 3D volumes
        (ops/outofcore.streamed_velocity_correlations)."""
        if not streamed:
            self._reject_stream_knobs(
                slab_rows=(slab_rows, None),
                chunk_rows=(chunk_rows, None),
                wire_dtype=(wire_dtype, None),
                prefetch_depth=(prefetch_depth, 2),
            )
            return tp_ops.velocity_correlations(*self._local_velocities(),
                                                lengths=self._domain_lengths(), mesh=self._dmesh)
        shape = self._shape3("velocity_correlations")
        return outofcore.streamed_velocity_correlations(
            self._streamed_loader(),
            shape,
            slab_rows=self._largest_divisor(shape[0], slab_rows),
            chunk_rows=self._largest_divisor(shape[0], chunk_rows),
            device=self.device,
            lengths=self._domain_lengths(),
            wire_dtype=wire_dtype,
            prefetch_depth=prefetch_depth,
        )

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
        if self._dmesh is not None:
            return volume_ops.mass_sum(self._slab("dens"), self.cell_volume_min, masks,
                                       mesh=self._dmesh)
        return volume_ops.mass_sum(self._volume("dens"), self.cell_volume_min, masks)

    def _uniform_pdf_weights(self, weight: Optional[str]):
        """Uniform cells share one volume, so "volume" weighting is the
        unweighted path (None); "mass" weights by dens (this rank's slab
        of it under a sharding mesh)."""
        if weight in (None, "volume"):
            return None
        if weight == "mass":
            return self._local_volume("dens")
        raise ValueError(f"Unknown pdf weight {weight}")

    @timer
    def pdf1d(self, field: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted 1D PDF of a field."""
        return volume_ops.pdf1d(
            self._local_volume(field), weights=self._uniform_pdf_weights(weight),
            mesh=self._dmesh, **kwargs
        )

    @timer
    def pdf2d(self, field1: str, field2: str, weight: Optional[str] = "volume", **kwargs):
        """Weighted joint PDF of two fields (the joint-histogram kernel)."""
        return volume_ops.pdf2d(
            self._local_volume(field1),
            self._local_volume(field2),
            weights=self._uniform_pdf_weights(weight),
            mesh=self._dmesh,
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
            self._local_volume(xfield),
            self._local_volume(yfield),
            weights=self._uniform_pdf_weights(weight),
            mesh=self._dmesh,
            **kwargs,
        )

    @timer
    def density_pdf(self, weight: Optional[str] = "volume", **kwargs) -> Dict[str, Any]:
        """Lognormality diagnostics of s = ln(rho/<rho>) (ops/volume.density_pdf)."""
        return volume_ops.density_pdf(
            self._local_volume("dens"), weights=self._uniform_pdf_weights(weight),
            mesh=self._dmesh, **kwargs
        )

    @timer
    def flame_surface(self, field: str = "flam", axis: int = 0) -> Dict[str, np.ndarray]:
        """Flame surface density of a progress variable: coarea-formula
        front area, wrinkling factor against the axis-normal
        cross-section, slab-resolved sigma(x) profile and gradient
        flame thickness (ops/flame.flame_surface; rank-local under a
        sharding mesh). Central differences, right for the non-periodic
        flame axis."""
        lengths = self._domain_lengths()
        shape = self._global_shape()
        deltas = [lengths[a] / shape[a] for a in range(self.ndim)]
        return flame_ops.flame_surface(self._local_volume(field), deltas, axis=axis,
                                       mesh=self._dmesh)

    @timer
    def projection(
        self, field: str = "dens", axis: int = 0, weight: Optional[str] = None
    ) -> Dict[str, Any]:
        """Line-of-sight projection map integral(field dl) along
        ``axis`` (column density for field="dens"); ``weight`` gives
        the w-weighted line average (ops/projection.project_uniform;
        rank-local under a sharding mesh). The map is over the kept axes
        with cell-center coordinates (2D datasets give a 1D column
        profile: "map" + "coord1")."""
        vol = self._local_volume(field)
        nd = vol.dim()
        lengths = self._domain_lengths()
        shape = self._global_shape()
        deltas = [lengths[a] / shape[a] for a in range(nd)]
        w = self._local_volume(weight) if weight is not None else None
        m = projection_ops.project_uniform(vol, deltas, axis=axis, weight=w, mesh=self._dmesh)
        b = np.asarray(self.domain_bounds, dtype=np.float64)
        keep = [a for a in range(nd) if a != axis]
        out: Dict[str, Any] = {"map": m}
        for i, a in enumerate(keep, start=1):
            out[f"coord{i}"] = b[a, 0] + (np.arange(shape[a]) + 0.5) * deltas[a]
        return out

    def _global_shape(self):
        """The whole volume's cells along each of the ``ndim`` axes (the
        file's, not the rank's slab)."""
        return (self.nxb, self.nyb, self.nzb)[: self.ndim]
