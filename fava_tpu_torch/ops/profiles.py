"""Axis-binned profile statistics: AMR block stacks and profile assembly.

Counterpart of fava_tpu/ops/profiles.py. Per-(block, row) moments of
the leaf stack are reduced in one read of the fields, then scattered
into finest-level bins, one refinement level at a time (every block of
a level covers the same number of fine bins). Second moments are
centered on per-row means, which keeps float32 fields accurate where a
one-pass expansion cancels.

Moments along x of a 3D stack go through the block-stack kernels K5/K6
(``cuda_kernels.block_row_moments`` and
``block_centered_row_moments``); a single uniform block profiled along x
takes K1/K2. Other axes use the plain torch reductions here, the
counterpart of fava_tpu's jnp code. Deviation from fava_tpu: its level
groups are padded to power-of-two buckets to bound jit recompiles;
PyTorch runs eagerly, so the groups hold the real blocks only and the
scatter is an ``index_add_`` over them (the sums are the same). The
per-row means stay float64 (fava_tpu cast them to the field dtype).
Results come back to the host as float64 numpy arrays, as in fava_tpu.

Under an active device mesh of more than one rank, the leaf blocks split
over every rank of the mesh (``parallel.runtime.block_sharding``): the
leaf list is zero-padded to a multiple of the rank total, each rank
copies only its share of the leaves out of the block stack and runs
K5 and then K6 on it (the per-row means are per (block, row), so K6
needs nothing from another rank), and one all_gather over the world
joins the shares' (raw, mu, cen) in the mesh's flat order before the pad
is trimmed. The level groups and the scatter then run as on one device.
Deviation from fava_tpu, which falls back to jnp reductions on the
sharded stack (fava_tpu/ops/profiles.py:240-251): the port keeps its
kernels on every rank; the outputs are the same, since each block's
moments are its own.

A uniform volume slab-sharded along x (``mesh=``, ROADMAP A11d) is one
block held as the ranks' x-slabs: its profiles are rank-local. Along x
the rows are whole on a rank, so the uniform fast case runs K1 and then
K2 on the slab and one all_gather joins the row statistics
(``uniform_row_stats``, which the flagship step's mesh branch shares);
fava_tpu's uniform fast case leaves its Pallas kernels when the array is
sharded (fava_tpu/ops/profiles.py:240-251, :330-343): the port keeps
them and gives the same outputs. Along y or z, and for the slice
profiles, each rank reduces its slab's cells into the whole profile's
rows (along x: its own rows, zero elsewhere), one all_reduce SUM joins
the raw sums, and the centred sums take a second pass about the global
row means and a second all_reduce. The bodies run on the slabs that a
``parallel.runtime.SpaceRanks`` plays (the ``*_ranked`` functions), so
the virtual-rank checks run the code that the collectives feed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from fava_tpu_torch.ops import cuda_kernels
from fava_tpu_torch.parallel import runtime
from fava_tpu_torch.utils import accum_dtype
from fava_tpu_torch.utils.profiling import SPAN_SYNC_INDEX, annotate

AXES_NAMES = "xyz"

# Velocity-pair order shared by every profile consumer: xx,xy,xz,yy,yz,zz.
VEL_PAIRS: Tuple[Tuple[int, int], ...] = tuple((i, j) for i in range(3) for j in range(i, 3))
_DIAG = tuple(VEL_PAIRS.index((i, i)) for i in range(3))


def _pair_indices(nvel: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(nvel) for j in range(i, nvel)]


def _reduce_dims(raxis: int) -> Tuple[int, ...]:
    return tuple(a for a in (1, 2, 3) if a != raxis + 1)


def _row_moments(fields: Tuple[torch.Tensor, ...], raxis: int, nvel: int) -> torch.Tensor:
    """Per-(block, row) raw sums along the profile axis, float64.

    ``fields`` = (dens, v0..v_{nvel-1}); each (nB, nx, ny, nz). Returns
    (1 + 2*nvel, nB, nrb): [dens, v_i..., dens*v_i...].
    """
    dens = fields[0].to(accum_dtype())
    vels = [v.to(accum_dtype()) for v in fields[1 : 1 + nvel]]
    red = _reduce_dims(raxis)
    moments = [dens.sum(dim=red)]
    moments += [v.sum(dim=red) for v in vels]
    moments += [(dens * v).sum(dim=red) for v in vels]
    return torch.stack(moments)


def _centered_row_moments_stack(
    fields: Tuple[torch.Tensor, ...], mu: torch.Tensor, raxis: int, nvel: int
) -> torch.Tensor:
    """Per-(block, row) moments about the per-row means ``mu`` (nvel, nB,
    nrb). Returns (npairs + nvel, nB, nrb): [sum d*ci*cj (i<=j)..., sum d*ci...]."""
    dens = fields[0].to(accum_dtype())
    red = _reduce_dims(raxis)

    def expand(m):
        shape = [m.shape[0], 1, 1, 1]
        shape[raxis + 1] = m.shape[1]
        return m.reshape(shape)

    cv = [v.to(accum_dtype()) - expand(mu[i]) for i, v in enumerate(fields[1 : 1 + nvel])]
    moments = [(dens * cv[i] * cv[j]).sum(dim=red) for (i, j) in _pair_indices(nvel)]
    moments += [(dens * c).sum(dim=red) for c in cv]
    return torch.stack(moments)


def _fine_index(ilo: torch.Tensor, length: int) -> torch.Tensor:
    """(nBg * length,) fine-bin index of each repeated row value."""
    return (ilo[:, None] + torch.arange(length, device=ilo.device)[None, :]).reshape(-1)


def _scatter_groups(groups, scales: Tuple[int, ...], nfine: int) -> torch.Tensor:
    """Scatter per-level grouped row sums into the finest-level profile.

    groups: (S, vol_frac, ilo) per level with S (M, nBg, nrb). Each block
    row spreads over ``scale`` consecutive fine bins starting at ilo.
    """
    m = groups[0][0].shape[0]
    prof = torch.zeros((m, nfine), dtype=accum_dtype(), device=groups[0][0].device)
    for (S, vf, ilo), s in zip(groups, scales):
        nrb = S.shape[-1]
        contrib = torch.repeat_interleave(S.to(accum_dtype()) * vf[None, :, None], s, dim=2)
        prof.index_add_(1, _fine_index(ilo, nrb * s), contrib.reshape(m, -1))
    return prof


class ProfileGeometry:
    """Host-side per-snapshot geometry for finest-level axis profiles."""

    def __init__(
        self,
        *,
        block_bounds: np.ndarray,
        refine_level: np.ndarray,
        blocklist: np.ndarray,
        domain_bounds: np.ndarray,
        ncells_vec: np.ndarray,
        nblks_vec: np.ndarray,
        ndim: int,
        raxis: int,
    ) -> None:
        self.ndim = int(ndim)
        self.raxis = int(raxis)
        self.blocklist = np.asarray(blocklist, dtype=np.int64)
        levels = np.asarray(refine_level)[self.blocklist]

        lmax = int(np.asarray(refine_level).max())
        self.lref_max = lmax
        lrefcells = 2 ** (lmax - 1)
        self.dims = [int(nc * nb * lrefcells) for nc, nb in zip(ncells_vec[:ndim], nblks_vec[:ndim])]
        self.nfine = self.dims[raxis]
        self.nrb = int(ncells_vec[raxis])

        rmin, rmax = float(domain_bounds[raxis, 0]), float(domain_bounds[raxis, 1])
        self.rmin, self.rmax = rmin, rmax
        self.span = np.linspace(rmin, rmax, self.nfine + 1, dtype=np.float64)

        widths = (domain_bounds[:ndim, 1] - domain_bounds[:ndim, 0]).astype(np.float64)
        self.min_deltas = widths / (
            np.asarray(ncells_vec[:ndim]) * np.asarray(nblks_vec[:ndim]) * 2 ** (lmax - 1)
        )

        # Layer cross-section (product of the non-profile axis widths).
        lv = 1.0
        full_widths = (domain_bounds[:, 1] - domain_bounds[:, 0]).astype(np.float64)
        for a in range(3):
            if a != raxis:
                lv *= full_widths[a]
        self.layer_area = lv

        # Per-block: cell volume x (min_delta / block delta along raxis).
        domain_volume = float(np.prod(full_widths))
        cells_at_level = np.ones_like(levels, dtype=np.float64)
        for a in range(ndim):
            cells_at_level *= ncells_vec[a] * nblks_vec[a] * 2.0 ** (levels - 1)
        cell_volumes = domain_volume / cells_at_level
        delta_r = widths[raxis] / (ncells_vec[raxis] * nblks_vec[raxis] * 2.0 ** (levels - 1))
        self.vol_fracs = cell_volumes * (self.min_deltas[raxis] / delta_r)

        # Fine-bin start index of each block along the profile axis.
        lo = np.asarray(block_bounds)[self.blocklist, raxis, 0].astype(np.float64)
        fine_delta = (rmax - rmin) / self.nfine
        self.ilo = np.rint((lo - rmin) / fine_delta).astype(np.int64)

        self.lref_n = (2 ** (lmax - levels)).astype(np.int64)
        self.levels = levels

        # Leaf blocks grouped by refinement level (positions in the leaf stack).
        self.groups: List[Tuple[int, np.ndarray]] = []
        for lev in sorted(set(int(l) for l in levels)):
            sel = np.nonzero(levels == lev)[0]
            self.groups.append((int(2 ** (lmax - lev)), sel))

    def device_groups(self, moments: torch.Tensor):
        """Split row moments (M, nBleaf, nrb) into level groups:
        ((S, vol_frac, ilo), ...) and their scales."""
        dev = moments.device
        groups = []
        scales = []
        for scale, sel in self.groups:
            idx = torch.as_tensor(sel, device=dev)
            S = torch.index_select(moments, 1, idx)
            vf = torch.as_tensor(self.vol_fracs[sel], dtype=accum_dtype(), device=dev)
            ilo = torch.as_tensor(self.ilo[sel], device=dev)
            groups.append((S, vf, ilo))
            scales.append(scale)
        return tuple(groups), tuple(scales)


def _leaf_fields(
    data: Dict[str, torch.Tensor], geom: ProfileGeometry, placement=None
) -> Tuple[torch.Tensor, ...]:
    """(dens, vels...) leaf stacks: a contiguous copy of each field's
    leaves, or with ``placement`` (a ``parallel.runtime.Placement`` of
    the leaf axis) of this rank's share only, the leaf list zero-padded
    to a multiple of its parts (the pad blocks have zero moments)."""
    names = ["dens"] + [f"vel{a}" for a in AXES_NAMES[: geom.ndim]]
    dev = data["dens"].device
    if placement is None:
        idx = torch.as_tensor(geom.blocklist, device=dev)
        return tuple(torch.index_select(data[name], 0, idx) for name in names)
    nleaf = geom.blocklist.size
    lo, hi = placement.bounds(-(-nleaf // placement.parts) * placement.parts)
    idx = torch.as_tensor(geom.blocklist[lo:hi], device=dev)
    out = []
    for name in names:
        x = data[name]
        share = x.new_zeros((hi - lo,) + tuple(x.shape[1:]))
        torch.index_select(x, 0, idx, out=share.narrow(0, 0, idx.numel()))
        out.append(share)
    return tuple(out)


def _share_stats(fields: Tuple[torch.Tensor, ...], geom: ProfileGeometry):
    """Raw + per-row-mean-centered moments of leaf stacks, float64: raw
    (1+2n, nB, nrb) [d, v_i, d*v_i], mu (n, nB, nrb) per-row velocity
    means, cen (npairs+n, nB, nrb) [d*ci*cj, d*ci] about mu. 3D stacks
    profiled along x take the K5/K6 kernels."""
    nvel = geom.ndim
    ncells_row = int(np.prod(fields[0].shape[1:])) // int(fields[0].shape[1 + geom.raxis])
    if geom.ndim == 3 and geom.raxis == 0:
        raw = cuda_kernels.block_row_moments(*fields)
        mu = (raw[1 : 1 + nvel] / ncells_row).contiguous()
        cen = cuda_kernels.block_centered_row_moments(*fields, mu)
        return raw, mu, cen
    raw = _row_moments(fields, raxis=geom.raxis, nvel=nvel)
    mu = raw[1 : 1 + nvel] / ncells_row
    cen = _centered_row_moments_stack(fields, mu, raxis=geom.raxis, nvel=nvel)
    return raw, mu, cen


def _slab_fields(data: Dict[str, torch.Tensor], nvel: int) -> Tuple[torch.Tensor, ...]:
    """(dens, vels...) of one uniform block's x-slab as (1, nx/d, ny, nz)."""
    names = ["dens"] + [f"vel{a}" for a in AXES_NAMES[:nvel]]
    return tuple(data[name].reshape((1,) + tuple(data[name].shape[-3:])) for name in names)


def _slab_row_sums(parts, geom: ProfileGeometry, ranks: runtime.SpaceRanks) -> torch.Tensor:
    """The whole profile's (M, 1, nrb) row sums from each rank's (M, 1,
    rows) part, by one all_reduce SUM: along x each part holds the rank's
    own rows, placed at their offset in zeros (x + 0 = x); along y or z
    each part sums the slab's cells of every row."""
    if geom.raxis == 0:
        placed = []
        for part, r in zip(parts, ranks.ranks):
            rows = part.shape[-1]
            full = part.new_zeros(tuple(part.shape[:-1]) + (geom.nrb,))
            full[..., r * rows : (r + 1) * rows] = part
            placed.append(full)
        parts = placed
    return ranks.reduce(parts)


def _slab_stats(data_list, geom: ProfileGeometry, ranks: runtime.SpaceRanks):
    """(raw, mu, cen) of one uniform block from its x-slabs (``data_list``,
    one dict per rank that ``ranks`` plays), as ``_share_stats`` gives
    them for the whole block: pass 1 the raw row sums and their join,
    pass 2 the sums about the global row means and their join."""
    nvel = geom.ndim
    fields = [_slab_fields(data, nvel) for data in data_list]
    ncells_row = int(np.prod(fields[0][0].shape[1:])) * ranks.d // geom.nrb
    raw = _slab_row_sums([_row_moments(f, geom.raxis, nvel) for f in fields], geom, ranks)
    mu = raw[1 : 1 + nvel] / ncells_row

    def rank_mu(f, r):
        if geom.raxis != 0:
            return mu
        rows = f[0].shape[1]
        return mu[..., r * rows : (r + 1) * rows]

    cen = _slab_row_sums(
        [_centered_row_moments_stack(f, rank_mu(f, r), geom.raxis, nvel)
         for f, r in zip(fields, ranks.ranks)], geom, ranks)
    return raw, mu, cen


def _stack_stats(data: Dict[str, torch.Tensor], geom: ProfileGeometry):
    """``_share_stats`` of the whole leaf stack; under a mesh of more
    than one rank, of this rank's share, joined over the world (module
    docstring)."""
    placement = runtime.block_sharding()
    if placement is None or placement.parts == 1:
        return _share_stats(_leaf_fields(data, geom), geom)
    share = _share_stats(_leaf_fields(data, geom, placement), geom)
    joined = runtime.gather_flat(torch.cat(share), dim=1)
    return _split_joined(joined, tuple(t.shape[0] for t in share), geom)


def _split_joined(joined: torch.Tensor, sizes: Tuple[int, ...], geom: ProfileGeometry):
    """(raw, mu, cen) of the whole leaf stack from every rank's packed
    share (``sizes`` rows each of raw, mu and cen) joined along the
    leaves in flat-rank order: the zero pad trimmed, the rows split."""
    return joined[:, : geom.blocklist.size].split(sizes)


def _scatter_centered_pairs(groups, scales: Tuple[int, ...], nfine: int, ref_fine, nvel: int):
    """Pass-2 scatter: centered covariances against a fine-bin reference.

    groups: (cen, s_d, mu, vf, ilo) per refinement level, with cen
    (npairs+nvel, nBg, nrb) centered about the per-row means mu and s_d
    (nBg, nrb) the density row sums. ``ref_fine`` (nvel, nfine) is the
    fine-bin profile to center against. Uses the exact identity

      sum d*(vi-ri)*(vj-rj) = C_ij + (mu_i-ri)*C_j + (mu_j-rj)*C_i
                              + (mu_i-ri)*(mu_j-rj)*S_d

    whose terms are all at fluctuation scale.
    """
    pairs = _pair_indices(nvel)
    npairs = len(pairs)
    adt = accum_dtype()
    ref = ref_fine.to(adt)
    prof = torch.zeros((npairs, nfine), dtype=adt, device=ref.device)
    for (cen, s_d, mu, vf, ilo), s in zip(groups, scales):
        nrb = s_d.shape[-1]
        idx = _fine_index(ilo, nrb * s).reshape(ilo.shape[0], nrb * s)  # (nBg, L)

        def rep(a):
            return torch.repeat_interleave(a.to(adt), s, dim=-1)

        sd_r = rep(s_d)
        delta = rep(mu) - ref[:, idx]  # (nvel, nBg, L)
        cov_r = rep(cen[:npairs])
        c1_r = rep(cen[npairs:])
        contrib = torch.stack(
            [
                cov_r[p] + delta[i] * c1_r[j] + delta[j] * c1_r[i] + delta[i] * delta[j] * sd_r
                for p, (i, j) in enumerate(pairs)
            ]
        )
        prof.index_add_(1, idx.reshape(-1), (contrib * vf[None, :, None]).reshape(npairs, -1))
    return prof


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float64).cpu().numpy()


def _grouped_stats(data_list, geom: ProfileGeometry, ranks=None):
    """Level-grouped (cen, S_d, mu) device groups + the pass-1 profile
    (host), of the leaf stack (``ranks`` None, ``data_list`` one dict) or
    of the x-slabs that ``ranks`` plays."""
    nvel = geom.ndim
    nraw = 1 + 2 * nvel
    npairs = len(_pair_indices(nvel))
    if ranks is None:
        raw, mu, cen = _stack_stats(data_list[0], geom)
    else:
        raw, mu, cen = _slab_stats(data_list, geom, ranks)
    # Recompose the d*v row sums from the centered residuals:
    # sum(d*v) = c1 + mu*sum(d) exactly, and c1 stays accurate where the
    # raw product sum cancels (near-zero-mean velocities).
    raw = torch.cat([raw[: 1 + nvel], cen[npairs : npairs + nvel] + mu * raw[0][None]])
    stacked = torch.cat([raw, cen, mu])
    groups, scales = geom.device_groups(stacked)
    raw_groups = tuple((g[0][:nraw], g[1], g[2]) for g in groups)
    cen_groups = tuple(
        (g[0][nraw : nraw + npairs + nvel], g[0][0], g[0][nraw + npairs + nvel :], g[1], g[2])
        for g in groups
    )
    prof_raw = _host(_scatter_groups(raw_groups, scales, geom.nfine))
    return prof_raw, cen_groups, scales


def _is_uniform_fast_case(geom: ProfileGeometry) -> bool:
    """Single uniform block profiled along x: rows == bins."""
    return (
        geom.ndim == 3
        and geom.raxis == 0
        and geom.blocklist.size == 1
        and geom.nfine == geom.nrb
    )


def uniform_row_stats(slabs, ranks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(moments (13, nx), centered (9, nx)) float64 row statistics of a
    uniform volume profiled along x: K1, then K2 about the per-row means,
    on each (dens, vx, vy, vz) x-slab in ``slabs`` (one for each rank that
    ``ranks`` plays; the whole volume on a single device, ``ranks`` None).
    Rows are whole on a rank, so both passes are local; one all_gather of
    the row statistics joins the slabs."""
    parts = []
    for dens, vx, vy, vz in slabs:
        layer = float(dens.shape[1] * dens.shape[2])
        moments = cuda_kernels.row_moments_volume(dens, vx, vy, vz)
        centered = cuda_kernels.centered_row_moments(
            dens, vx, vy, vz, (moments[1:4] / layer).contiguous())
        parts.append(torch.cat([moments, centered]))
    rows = parts[0] if ranks is None else ranks.gather(parts, dim=1)
    return rows.split([cuda_kernels.NMOM, cuda_kernels.NCEN])


def _uniform_centered_stats(data_list, geom: ProfileGeometry, ranks=None):
    """Raw first moments + centered second moments of one uniform block
    (K1, K2), whole or as the x-slabs that ``ranks`` plays. Returns host
    (d_row, v_rows, cov(6,n), c1(3,n), means_rows), all unscaled."""
    blk = int(geom.blocklist[0])
    slabs = [tuple(data[name][blk].contiguous() for name in ("dens", "velx", "vely", "velz"))
             for data in data_list]
    moments, centered = uniform_row_stats(slabs, ranks)
    ncells_per_row = slabs[0][0].shape[1] * slabs[0][0].shape[2]
    means_rows = moments[1:4] / ncells_per_row
    packed = _host(torch.cat([moments[0][None], moments[1:4], centered, means_rows]))
    return packed[0], packed[1:4], packed[4:10], packed[10:13], packed[13:16]


def _ranks(mesh):
    return None if mesh is None else runtime.SpaceRanks(mesh)


def reynolds_stress(
    data: Dict[str, torch.Tensor],
    geom: ProfileGeometry,
    mesh=None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Finest-resolution Reynolds-stress profiles along ``geom.raxis``:
    layer means of dens/vel, then density-weighted velocity covariances,
    both normalized by layer volume (cross-section x finest cell width).
    With ``mesh``, ``data`` holds the rank's x-slabs of one uniform block
    slab-sharded over the mesh's space axis (module docstring)."""
    return reynolds_stress_ranked([data], geom, _ranks(mesh))


def reynolds_stress_ranked(data_list, geom: ProfileGeometry, ranks=None):
    """``reynolds_stress`` of the leaf stack (``ranks`` None) or of the
    x-slabs that ``ranks`` plays, one dict of ``data_list`` each."""
    axes = AXES_NAMES[: geom.ndim]
    layer_volume = geom.layer_area * geom.min_deltas[geom.raxis]

    if _is_uniform_fast_case(geom):
        d_row, v_rows, cov, _c1, _means_rows = _uniform_centered_stats(data_list, geom, ranks)
        scale = float(geom.vol_fracs[0]) / layer_volume
        means: Dict[str, np.ndarray] = {"dens": d_row * scale}
        for i, a in enumerate(axes):
            means[f"vel{a}"] = v_rows[i] * scale
        stress: Dict[str, np.ndarray] = {}
        for p, (i, j) in enumerate(_pair_indices(3)):
            stress[f"R{axes[i]}{axes[j]}"] = cov[p] * scale
        return geom.span.copy(), stress, means

    prof_raw, cen_groups, scales = _grouped_stats(data_list, geom, ranks)
    means = {"dens": prof_raw[0] / layer_volume}
    for i, a in enumerate(axes):
        means[f"vel{a}"] = prof_raw[1 + i] / layer_volume

    ref_fine = torch.as_tensor(
        np.stack([means[f"vel{a}"] for a in axes]), dtype=accum_dtype(), device=cen_groups[0][0].device
    )
    cov = _host(_scatter_centered_pairs(cen_groups, scales, geom.nfine, ref_fine, geom.ndim))
    stress = {}
    for p, (i, j) in enumerate(_pair_indices(geom.ndim)):
        stress[f"R{axes[i]}{axes[j]}"] = cov[p] / layer_volume
    return geom.span.copy(), stress, means


def favre_profiles(
    data: Dict[str, torch.Tensor],
    geom: ProfileGeometry,
    mesh=None,
) -> Dict[str, np.ndarray | Dict[str, np.ndarray]]:
    """Favre (density-weighted) mean profiles and mass-weighted RMS:
      favre_mean v~_i = <rho v_i> / <rho>
      favre_rms  v''_i = sqrt(<rho (v_i - v~_i)^2> / <rho>)
    from the same moments as reynolds_stress (``mesh`` as there)."""
    return favre_profiles_ranked([data], geom, _ranks(mesh))


def favre_profiles_ranked(data_list, geom: ProfileGeometry, ranks=None):
    """``favre_profiles`` of the leaf stack or of the x-slabs that
    ``ranks`` plays (``reynolds_stress_ranked``)."""
    nvel = geom.ndim
    axes = AXES_NAMES[:nvel]
    layer_volume = geom.layer_area * geom.min_deltas[geom.raxis]

    if _is_uniform_fast_case(geom):
        d64, _v_rows, cov, c1, means_rows = _uniform_centered_stats(data_list, geom, ranks)
        scale = float(geom.vol_fracs[0]) / layer_volume
        safe_d = np.where(d64 > 0, d64, 1.0)
        pairs3 = _pair_indices(3)
        out: Dict[str, np.ndarray | Dict[str, np.ndarray]] = {
            "span": geom.span.copy(),
            "mean_dens": d64 * scale,
            "favre_mean": {},
            "favre_rms": {},
        }
        for i, a in enumerate(axes):
            # mu + sum(d*(v-mu))/sum(d): exact identity, conditioned
            # where the raw sum(d*v) cancels (zero-mean velocities).
            fmean = means_rows[i] + c1[i] / safe_d
            di = fmean - means_rows[i]
            p = pairs3.index((i, i))
            var = (cov[p] - 2.0 * di * c1[i] + di * di * d64) / safe_d
            out["favre_mean"][f"vel{a}"] = fmean
            out["favre_rms"][f"vel{a}"] = np.sqrt(np.maximum(var, 0.0))
        return out

    prof_raw, cen_groups, scales = _grouped_stats(data_list, geom, ranks)
    d0 = prof_raw[0]
    dv = prof_raw[1 + nvel : 1 + 2 * nvel]
    pairs = _pair_indices(nvel)

    safe_d = np.where(d0 > 0, d0, 1.0)
    fmeans = np.stack([dv[i] / safe_d for i in range(nvel)])
    # Centered scatter against the Favre means: diagonal entries are
    # the mass-weighted variance numerators sum(d*(v_i - v~_i)^2).
    ref_fine = torch.as_tensor(fmeans, dtype=accum_dtype(), device=cen_groups[0][0].device)
    cov = _host(_scatter_centered_pairs(cen_groups, scales, geom.nfine, ref_fine, nvel))
    out = {
        "span": geom.span.copy(),
        "mean_dens": d0 / layer_volume,
        "favre_mean": {},
        "favre_rms": {},
    }
    for i, a in enumerate(axes):
        var = cov[pairs.index((i, i))] / safe_d
        out["favre_mean"][f"vel{a}"] = fmeans[i]
        out["favre_rms"][f"vel{a}"] = np.sqrt(np.maximum(var, 0.0))
    return out


def slice_integral(
    field_data: torch.Tensor,
    geom: ProfileGeometry,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Finest-resolution axis profile of sum(field * vol_frac) per layer.
    With ``mesh``, ``field_data`` is the rank's x-slab of one uniform
    block slab-sharded over the mesh's space axis."""
    return slice_integral_ranked([field_data], geom, _ranks(mesh))


def slice_integral_ranked(field_list, geom: ProfileGeometry, ranks=None):
    """``slice_integral`` of the block stack (``ranks`` None) or of the
    x-slabs that ``ranks`` plays: each slab's row sums, one all_reduce."""
    if ranks is None:
        field_data = field_list[0]
        idx = torch.as_tensor(geom.blocklist, device=field_data.device)
        moments = _row_moments((torch.index_select(field_data, 0, idx),), raxis=geom.raxis, nvel=0)
    else:
        moments = _slab_row_sums(
            [_row_moments(_slab_fields({"dens": f}, 0), raxis=geom.raxis, nvel=0)
             for f in field_list], geom, ranks)
    groups, scales = geom.device_groups(moments)
    return geom.span.copy(), _host(_scatter_groups(groups, scales, geom.nfine))[0]


def slice_average(
    field_data: torch.Tensor,
    geom: ProfileGeometry,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """slice_integral normalized by layer volume."""
    span, alp = slice_integral(field_data, geom, mesh)
    layer_volume = geom.layer_area * geom.min_deltas[geom.raxis]
    return span, alp / layer_volume


def assemble_profile_stats(d_row, means, c1, cov, layer):
    """Reynolds stress + Favre mean/RMS from centered per-bin moments.

    Inputs are stacked rows: d_row (nx,), means (3, nx) volume-mean
    velocities, c1 (3, nx) = sum(d*(v-mu)), cov (6, nx) = sum(d*ci*cj)
    in VEL_PAIRS order, layer = cells/bin.

    favre_mean = mu + c1/sum(d); the RMS variance is the centered
    covariance shifted to the Favre mean. A vacuum bin (sum(d) == 0)
    has c1 == cov == 0, so dividing by the guarded 1 yields
    favre_mean == means and rms == 0 instead of NaN.
    """
    stress = cov / layer
    safe_d = torch.where(d_row > 0, d_row, torch.ones_like(d_row))
    favre_mean = means + c1 / safe_d
    di = favre_mean - means
    with annotate(SPAN_SYNC_INDEX):
        diag_cov = cov[list(_DIAG)]
    var = (diag_cov - 2.0 * di * c1 + di * di * d_row) / safe_d
    favre_rms = torch.sqrt(torch.clamp(var, min=0.0))
    return stress, favre_mean, favre_rms
