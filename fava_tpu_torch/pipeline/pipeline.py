"""Pipeline orchestration with JSON checkpoint/resume.

Counterpart of fava_tpu/pipeline/pipeline.py on one device: four stages
over a FLASH snapshot series — per-plt Reynolds stress + flame-window
fit, window-trajectory smoothing, moving-window extraction via
from_amr, and uniform-data analyses (fractal dimension, structure
functions, KE spectra, and the optional ones the settings enable) —
with a ``fava.checkpoint`` JSON for resumability and SIGINT/SIGTERM-safe
checkpointing via the interrupt handler. The settings schema, the
checkpoint format and the analysis files' group and dataset names are
fava_tpu's. The analysis files are read through ``io/h5lite``; every
model is built on the pipeline's ``device``.
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from fava_tpu_torch.io import h5lite
from fava_tpu_torch.models import FLASH
from fava_tpu_torch.utils import FAVAInterruptHandler, resolve_device, timer

LOGGER = logging.getLogger(__name__)

PIPELINE_CHECKPOINT_NAME = "fava.checkpoint"
PIPELINE_SETTINGS_NAME = "pipeline_settings.json"


class PipelineSettingsError(ValueError):
    """Raised at load_settings time for malformed pipeline settings."""


# Settings schema (reference contract: fava/__main__.py:27-43 +
# fava/pipeline_settings.json). Top-level scalars are validated in
# load_settings; stage/analysis entries are {skip, settings} dicts and
# required per-analysis settings keys are listed here so a missing pdf
# field name fails at startup, not as a bare TypeError mid-stage-4.
_STAGE_KEYS = {"reynolds stress", "extract windows", "analyze uniform data"}
_ANALYSIS_KEYS = {
    "fractal dimension": ("field",),
    "structure functions": (),
    "kinetic energy spectra": (),
    "favre profiles": (),
    "reynolds stresses uniform": (),
    "pdf1d": ("field",),
    "pdf2d": ("field1", "field2"),
    "density pdf": (),
    "projection": (),
    "scalar spectra": ("field",),
    "enstrophy spectra": (),
    "helicity spectra": (),
    "transfer spectra": (),
    "decomposed spectra": (),
    "anisotropic spectra": (),
    "flame surface": (),
    "turbulence summary": (),
    "velocity gradient statistics": (),
    "gradient invariant pdfs": (),
    "velocity increment pdfs": (),
    "filtered ke flux": (),
    "structure function exponents": (),
    "binned statistic": ("xfield", "yfield"),
    "two point correlation": ("field",),
    "velocity correlations": (),
}
# Stage 4 runs these whether or not they appear in settings (the
# reference's fixed three) — their required keys are validated even
# when the entry is absent.
_ALWAYS_RUN = {"fractal dimension", "structure functions", "kinetic energy spectra"}
_KNOWN_TOP_KEYS = (
    {"basename", "dimension", "model", "data folder", "output folder", "flame window"}
    | _STAGE_KEYS
    | set(_ANALYSIS_KEYS)
)


def snap_window_axis0(
    subdomain_coords: np.ndarray, dom: np.ndarray, delta: float
) -> np.ndarray:
    """Snap the x row of a subdomain box to an exact fine-cell count.

    A fit-centered window puts BOTH bounds exactly on the BCID rounding
    tie (``int32(0.5 + k + 0.5)``, reference _flash.py:967) where 1-ulp
    float noise independently decides each end — measured on chip: one
    snapshot of three extracted 511x512x512. On TPU a wobbling width
    forces a fresh multi-minute XLA compile of every stage-4 program, so
    snap the left bound to its nearest cell edge and place both bounds a
    quarter cell INSIDE the target edges: ``int32(0.5 + k +- 0.25)``
    rounds unconditionally, every snapshot extracts exactly ``ncells``,
    and the window center stays within half a cell of the fit (below the
    fit's own uncertainty). Side effect: the x row never touches 0.0, so
    a clamped window cannot trip the reference's all-rows-touch-zero
    whole-domain sentinel (_flash.py:965) either.
    """
    out = np.asarray(subdomain_coords, dtype=np.float64).copy()
    ncells = max(int(round((out[0, 1] - out[0, 0]) / delta)), 1)
    ntot = int(round((dom[0, 1] - dom[0, 0]) / delta))
    ncells = min(ncells, ntot)
    li = int(np.floor((out[0, 0] - dom[0, 0]) / delta + 0.5))
    li = max(0, min(li, ntot - ncells))
    out[0] = [
        dom[0, 0] + (li + 0.25) * delta,
        dom[0, 0] + (li + ncells - 0.25) * delta,
    ]
    return out


def validate_settings(settings: Dict[str, Any]) -> None:
    """Schema-check a pipeline settings dict; raise PipelineSettingsError.

    Catches, at startup: non-dict stage/analysis entries, non-dict or
    missing per-analysis ``settings``, and missing required analysis
    settings (e.g. pdf1d without a field name). Unknown top-level keys
    only warn — forward/backward compatibility with reference settings
    files matters more than strictness there.
    """
    for key in settings:
        if key not in _KNOWN_TOP_KEYS:
            LOGGER.warning("unknown pipeline setting %r ignored", key)
    for key in _STAGE_KEYS | set(_ANALYSIS_KEYS):
        if key not in settings:
            continue
        entry = settings[key]
        if not isinstance(entry, dict):
            raise PipelineSettingsError(
                f"pipeline setting {key!r} must be an object with optional "
                f"'skip'/'settings' keys, got {type(entry).__name__}"
            )
        if "settings" in entry and not isinstance(entry["settings"], dict):
            raise PipelineSettingsError(
                f"pipeline setting {key!r}.settings must be an object, "
                f"got {type(entry['settings']).__name__}"
            )
    # Every analysis here runs inside stage 4; with the stage skipped
    # none of them can execute, so their settings need not be complete
    # (a present-but-stub entry alongside a skipped stage is valid).
    stage4_skipped = settings.get("analyze uniform data", {}).get("skip", False)
    for name, required in _ANALYSIS_KEYS.items():
        if stage4_skipped:
            continue
        enabled = name in settings or name in _ALWAYS_RUN
        if not enabled or settings.get(name, {}).get("skip", False):
            continue
        analysis_settings = settings.get(name, {}).get("settings", {})
        for req in required:
            if req not in analysis_settings:
                raise PipelineSettingsError(
                    f"analysis {name!r} is enabled but its settings are missing "
                    f"the required key {req!r} (have: {sorted(analysis_settings)})"
                )


class Pipeline:
    """Stage driver over a FLASH model directory, computing on ``device``."""

    def __init__(self, workdir: Optional[Path] = None, device="cuda") -> None:
        self.device = resolve_device(device)
        self.workdir = Path(workdir) if workdir is not None else Path.cwd()
        self.checkpoint_file = self.workdir / PIPELINE_CHECKPOINT_NAME
        self.settings_file = self.workdir / PIPELINE_SETTINGS_NAME
        self.checkpoint_data: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # Settings / checkpoint
    def load_settings(self, settings_path: Optional[Path] = None) -> None:
        path = Path(settings_path) if settings_path is not None else self.settings_file
        with path.open("r") as f:
            self.settings: Dict[str, Any] = json.load(f)

        validate_settings(self.settings)
        self.checkpoint_data["settings"] = copy.deepcopy(self.settings)
        self.basename: str = self._validated("basename", str)
        self.ndim: int = self._validated("dimension", int)
        self.model_name: str = self._validated("model", str)
        self.data_dir = Path(self._validated("data folder", str))
        self.output_dir = Path(self._validated("output folder", str))
        self.model: FLASH = FLASH(self.data_dir, device=self.device)

    def _validated(self, key: str, vtype) -> Any:
        # Not asserts: user-facing settings errors must survive
        # python -O (asserts are stripped under optimization).
        if key not in self.settings:
            raise PipelineSettingsError(f"Missing pipeline setting: {key}")
        if not isinstance(self.settings[key], vtype):
            raise PipelineSettingsError(
                f"Setting {key!r} must be {vtype.__name__}, "
                f"got {type(self.settings[key]).__name__}"
            )
        return self.settings[key]

    def checkpoint(self) -> None:
        with self.checkpoint_file.open("w") as f:
            json.dump(self.checkpoint_data, f, ensure_ascii=True, indent=4, default=str)

    def restart(self) -> None:
        if self.checkpoint_file.is_file():
            with self.checkpoint_file.open("r") as f:
                self.checkpoint_data = json.load(f)
        self.load_settings()

    def refresh_model(self) -> None:
        # Extracted uniform files land in output_dir; rescan there when
        # it differs from the data dir (the reference assumes they match).
        target = self.data_dir
        if self.output_dir != self.data_dir and any(self.output_dir.glob("*hdf5_uniform_????")):
            target = self.output_dir
        self.model = FLASH(target, device=self.device)

    # ------------------------------------------------------------------
    def _window_settings(self) -> tuple:
        """(half_width, dx, transverse) from the 'flame window' settings
        — ONE definition of the 16e5/transverse defaults, shared by
        stage 1 (fit window) and stage 3 (extraction window) so the two
        stages can never silently disagree about the window geometry."""
        window = self.settings.get("flame window", {})
        half_width = float(window.get("half width", 16e5))
        dx = float(window.get("dx", 0.0))
        transverse = window.get("transverse", [-16e5, 16e5])
        return half_width, dx, transverse

    def _flam_or_rpv1(self) -> bool:
        """Whether the loaded file carries ``rpv1`` (preferred) or ``flam``,
        which becomes ``self.flam``. The mesh's own lookup answers
        (``_local_data``: the field as this rank holds it), so a sharded
        volume is not gathered to find it."""
        self.flam = "rpv1"
        if self.model.mesh._local_data(self.flam) is None:
            self.flam = "flam"
        return self.model.mesh._local_data(self.flam) is not None

    # ------------------------------------------------------------------
    # Stage 1: per-plt Reynolds stress + flame window
    def reynolds_stress(self, index: int) -> None:
        file_type = "plt"
        self.model.load(file_index=index, file_type=file_type)
        fn = self.output_dir / self.model.convert_filename_type(file_type, "anl").name

        print(f"[stage 1] reynolds stress -> {fn}", flush=True)

        # HDF5 group names are the on-disk contract shared with the
        # reference's analysis files; do not rename.
        stress_group = "reynolds stresses"
        scalars_group = "scalars"
        try:
            with h5lite.File(fn, "r") as f:
                radius = f[stress_group]["radius"][()]
                tensor = {k: f[stress_group]["tensor"][k][()] for k in f[stress_group]["tensor"]}
        except Exception:
            radius, tensor, vel_means = self.model.reynolds_stress()
            self.model.save_to_hdf5(
                data={stress_group: {"tensor": tensor, "radius": radius, "means": vel_means}},
                filename=fn,
            )

        if not self._flam_or_rpv1():
            return

        span, flame_profile = self.model.slice_average(self.flam, axis=0)
        bin_centers = 0.5 * (radius[1:] + radius[:-1])
        mask = np.argwhere((0.0 < flame_profile) & (flame_profile < 1.0)).flatten()
        if mask.size < 4:
            mask = None

        try:
            centroid = self.model.mesh.flame_window(bin_centers, tensor, mask)
        except Exception as exc:
            # LM non-convergence on degenerate profiles: fall back to the
            # transverse-stress peak so the pipeline stays resumable.
            LOGGER.warning("flame_window fit failed (%s); using stress peak", exc)
            centroid = float(bin_centers[np.argmax(tensor["Ryy"] + tensor["Rzz"])])

        half_width, dx, _ = self._window_settings()

        left = self.model.mesh.domain_bounds[:, 0].copy()
        right = self.model.mesh.domain_bounds[:, 1].copy()
        left[0] = centroid - half_width + dx
        right[0] = centroid + half_width + dx

        window_bounds = right - left
        # Diagnostic only (stage 3 re-derives and SNAPS the real window);
        # round, don't truncate — 1.0/delta can land 1 ulp under an
        # integer and print 511 for a window stage 3 extracts as 512.
        window_dimensions = np.rint(
            window_bounds / self.model.mesh.get_minimum_deltas(axis=1)
        ).astype(int)

        print(f"[stage 1] flame window right={right} dims={window_dimensions}", flush=True)
        self.model.save_to_hdf5(
            data={
                scalars_group: {
                    "time": self.model.mesh.time,
                    "window left": left,
                    "window right": right,
                    "window dimensions": window_dimensions,
                }
            },
            filename=fn,
        )

    # ------------------------------------------------------------------
    # Stage 2: smooth the window trajectory across the series
    def smooth_window_trajectory(self) -> None:
        xs, ts = [], []
        for p in sorted(self.model.plt_files["by index"].keys()):
            self.model.load(file_index=p, file_type="plt")
            fn = self.output_dir / self.model.convert_filename_type("plt", "anl").name
            # Snapshots without window scalars (stage 1 skipped, or a
            # plt without flam/rpv1) must not kill the pipeline between
            # stages — skip them from the fit.
            try:
                with h5lite.File(fn, "r") as f:
                    win_right = f["scalars"]["window right"][()]
            except (OSError, KeyError) as exc:
                LOGGER.warning("no window scalars for plt index %s (%s); skipping", p, exc)
                continue
            xs.append(win_right[0])
            ts.append(self.model.mesh.time)

        n = len(xs)
        self.xmax = np.asarray(xs)
        self.time = np.asarray(ts)
        if n == 0:
            LOGGER.warning("no window trajectory data; window extraction will be skipped")
            self.func = None
            self.t0 = self.x0 = 0.0
            return
        if n > 1 and np.ptp(self.time) > 0:
            coef = np.polyfit(self.time, self.xmax, 1)
        else:
            coef = np.array([0.0, self.xmax[0]])
        self.t0 = self.time[0]
        self.x0 = self.xmax[0]
        self.func = np.poly1d(coef)

    # ------------------------------------------------------------------
    # Stage 3: extract moving flame windows to uniform files
    def extract_windows(self, index: int) -> None:
        if getattr(self, "func", None) is None:
            LOGGER.warning("no window trajectory; skipping window extraction")
            return
        # Artifact check BEFORE the load: resuming a long series must
        # not re-upload every already-extracted snapshot's fields
        # through the host->device path just to early-return.
        src = self.model.plt_files["by index"][index]
        fn = self.output_dir / src.name.replace("plt_cnt", "uniform")
        if fn.is_file():
            print(f"[stage 3] window exists -> {fn}", flush=True)
            return
        self.model.load(file_index=index, file_type="plt")
        if not self._flam_or_rpv1():
            LOGGER.warning(
                "[stage 3] %s has no flam/rpv1 field; no window extracted", src.name
            )
            return

        half_width, _, transverse = self._window_settings()

        xmax = self.x0 + (self.func(self.model.mesh.time) - self.func(self.t0))
        subdomain_coords = np.array(
            [[xmax - 2 * half_width, xmax], list(transverse), list(transverse)]
        )
        # Clamp into the domain so a drifting window stays extractable
        # (from_amr no-ops on out-of-domain subdomains, like the reference).
        dom = self.model.mesh.domain_bounds
        for a in range(3):
            width = subdomain_coords[a, 1] - subdomain_coords[a, 0]
            if subdomain_coords[a, 0] < dom[a, 0]:
                subdomain_coords[a] = [dom[a, 0], min(dom[a, 0] + width, dom[a, 1])]
            if subdomain_coords[a, 1] > dom[a, 1]:
                subdomain_coords[a] = [max(dom[a, 1] - width, dom[a, 0]), dom[a, 1]]
        # Snap x to an exact fine-cell count — see snap_window_axis0:
        # the fit-centered bounds land on the BCID rounding tie, and a
        # 511-vs-512 width wobble changes every stage-4 shape (an odd x
        # extent takes the unfolded shell binning).
        subdomain_coords = snap_window_axis0(
            subdomain_coords,
            dom,
            float(self.model.mesh.get_minimum_deltas(axis=0)),
        )
        fields = [self.flam, "dens", "pres", "temp", "velx", "vely", "velz", "divv", "igtm", "vort"]
        fields = [f for f in fields if f in self.model.mesh.fields]

        print(f"[stage 3] extract window -> {fn}", flush=True)
        self.model.mesh.from_amr(subdomain_coords=subdomain_coords, fields=fields, filename=fn)

    # ------------------------------------------------------------------
    # Stage 4: uniform-grid analyses with per-analysis resume cursor
    def analyze_uniform_data(self, index: int) -> None:
        stage_key = "analyze uniform data"  # checkpoint-format key
        self.model.load(file_index=index, file_type="uni")
        if not self._flam_or_rpv1():
            # Reference parity gate — but say so loudly: this skips the
            # WHOLE analysis battery for the snapshot (spectra included)
            # and the pipeline will record the index as analyzed.
            LOGGER.warning(
                "[stage 4] uniform file index %d has no flam/rpv1 field; "
                "ALL uniform analyses skipped for it",
                index,
            )
            return

        fn = self.output_dir / self.model.convert_filename_type("uni", "anl").name
        print(f"[stage 4] uniform analyses -> {fn}", flush=True)

        analyses = {
            "fractal dimension": self.model.fractal_dimension,
            "structure functions": self.model.structure_functions,
            "kinetic energy spectra": self.model.kinetic_energy_spectra,
        }
        # Optional extra analyses, enabled by their presence in settings
        # (beyond the reference's fixed three). The order is fava_tpu's,
        # so a checkpointed resume cursor means the same analysis in both.
        optional = {
            "favre profiles": lambda **kw: _favre_as_dict(self.model.favre_profiles(**kw)),
            "reynolds stresses uniform": lambda **kw: _reynolds_as_dict(
                self.model.reynolds_stress(**kw)
            ),
            "pdf1d": lambda **kw: self.model.pdf1d(**kw),
            "pdf2d": lambda **kw: self.model.pdf2d(**kw),
            "binned statistic": lambda **kw: self.model.binned_statistic(**kw),
            "density pdf": lambda **kw: self.model.density_pdf(**kw),
            "projection": lambda **kw: self.model.projection(**kw),
            "scalar spectra": lambda **kw: self.model.scalar_spectra(**kw),
            "enstrophy spectra": lambda **kw: self.model.enstrophy_spectra(**kw),
            "helicity spectra": lambda **kw: self.model.helicity_spectra(**kw),
            "transfer spectra": lambda **kw: self.model.transfer_spectra(**kw),
            "decomposed spectra": lambda **kw: self.model.decomposed_kinetic_energy_spectra(
                **kw
            ),
            "anisotropic spectra": lambda **kw: self.model.anisotropic_kinetic_energy_spectra(
                **kw
            ),
            "flame surface": lambda **kw: self.model.flame_surface(**kw),
            "turbulence summary": lambda **kw: self.model.turbulence_summary(**kw),
            "velocity gradient statistics": lambda **kw: self.model.velocity_gradient_statistics(
                **kw
            ),
            "gradient invariant pdfs": lambda **kw: self.model.gradient_invariant_pdfs(**kw),
            "velocity increment pdfs": lambda **kw: self.model.velocity_increment_pdfs(**kw),
            "filtered ke flux": lambda **kw: self.model.filtered_kinetic_energy_flux(**kw),
            "structure function exponents": lambda **kw: _exponents_as_dict(
                self.model.structure_function_exponents(**kw)
            ),
            "two point correlation": lambda **kw: self.model.two_point_correlation(**kw),
            "velocity correlations": lambda **kw: self.model.velocity_correlations(**kw),
        }
        for key, opt_fn in optional.items():
            if key in self.settings:
                analyses[key] = opt_fn

        names = list(analyses.keys())
        resume_name = self.checkpoint_data.setdefault(stage_key, {}).get("analysis")
        first = names.index(resume_name) if resume_name in names else 0

        for name in names[first:]:
            self.checkpoint_data[stage_key]["analysis"] = name
            if not self.settings.get(name, {}).get("skip", False):
                analysis_settings = self.settings.get(name, {}).get("settings", {})
                try:
                    result = analyses[name](**analysis_settings)
                except TypeError as exc:
                    # Name the analysis and the settings in play — a bare
                    # TypeError from the call site is unactionable. The
                    # original traceback is chained: this may also be a
                    # genuine bug inside the analysis, not a settings
                    # mismatch, so don't claim certainty either way.
                    raise PipelineSettingsError(
                        f"analysis {name!r} raised TypeError with settings "
                        f"{sorted(analysis_settings)} — check the settings keys "
                        f"against the analysis signature (chained traceback has "
                        f"the original error): {exc}"
                    ) from exc
                self.model.save_to_hdf5(data={name: result}, filename=fn)

        self.checkpoint_data[stage_key]["analysis"] = None


def _favre_as_dict(out: dict) -> dict:
    return {
        "span": out["span"],
        "mean_dens": out["mean_dens"],
        "favre_mean": out["favre_mean"],
        "favre_rms": out["favre_rms"],
    }


def _exponents_as_dict(out: dict) -> dict:
    # HDF5-writable view: bools/None become scalars (0 = plain fit).
    return {
        "orders": out["orders"],
        "ess": int(out["ess"]),
        "reference_order": int(out["reference_order"] or 0),
        "longitudinal": dict(out["longitudinal"]),
        "transverse": dict(out["transverse"]),
    }


def _reynolds_as_dict(result) -> dict:
    radius, stress, means = result
    return {"radius": radius, "tensor": stress, "means": means}


@timer
def main(workdir: Optional[Path] = None, device="cuda") -> int:
    from fava_tpu_torch.utils import configure_logging, enable_compilation_cache

    configure_logging()
    enable_compilation_cache()

    pipe = Pipeline(workdir, device=device)
    pipe.restart()
    pipe.output_dir.mkdir(parents=True, exist_ok=True)

    print(f"pipeline starting; checkpoint state: {pipe.checkpoint_data}", flush=True)

    def remaining(catalog, stage: str):
        # Resume from the checkpointed index by KEY VALUE (not list
        # position), so resume stays correct even if the catalog keys
        # are ever non-contiguous. Checkpoint format (last index + 1)
        # matches the reference's fava.checkpoint for drop-in resume.
        first = pipe.checkpoint_data.get(stage, {}).get("index", 0)
        return [k for k in sorted(catalog["by index"].keys()) if k >= first]

    with FAVAInterruptHandler(external_handler=pipe.checkpoint):
        stage = "reynolds stress"
        if not pipe.settings.get(stage, {}).get("skip", False):
            for i in remaining(pipe.model.plt_files, stage):
                pipe.reynolds_stress(index=i)
                pipe.checkpoint_data[stage] = {"index": i + 1}
                pipe.checkpoint()

        pipe.smooth_window_trajectory()

        stage = "extract windows"
        if not pipe.settings.get(stage, {}).get("skip", False):
            if getattr(pipe, "func", None) is None:
                # No window trajectory (stage 1 skipped / no anl
                # scalars): every extract would be a no-op. Do NOT
                # advance the checkpoint — recording undone work as
                # done would permanently skip extraction on the re-run
                # after the user fixes stage 1.
                LOGGER.warning(
                    "[stage 3] no window trajectory; stage skipped and NOT "
                    "checkpointed (re-run after stage 1 produces one)"
                )
            else:
                for i in remaining(pipe.model.plt_files, stage):
                    pipe.extract_windows(index=i)
                    pipe.checkpoint_data[stage] = {"index": i + 1}
                    pipe.checkpoint()

        pipe.refresh_model()

        stage = "analyze uniform data"
        # Honor a stage-level skip like the other stages (per-analysis
        # skips remain available inside analyze_uniform_data).
        if not pipe.settings.get(stage, {}).get("skip", False):
            pipe.checkpoint_data.setdefault(stage, {})
            for i in remaining(pipe.model.uni_files, stage):
                pipe.analyze_uniform_data(i)
                pipe.checkpoint_data[stage]["index"] = i + 1
                pipe.checkpoint()

        print("pipeline complete", flush=True)
    return 0
