"""FLASH model frontend: file catalogs and load dispatch.

Counterpart of fava_tpu/models/flash.py: the data directory is globbed
into five catalogs (chk/plt/prt/uni/anl), each addressable "by number"
(the 4-digit suffix) or "by index" (sorted position). ``load`` sends
``chk``/``plt`` files to the AMR mesh, ``uni`` files to the uniform mesh
and ``prt`` files to the particle table (``self.particles``);
``chk_prt`` reads the mesh and the particle table of one checkpoint,
``plt_prt`` a plt mesh and the part file of the same index.
"""

from __future__ import annotations

from enum import Enum
from pathlib import Path
from typing import Dict, Optional

from fava_tpu_torch.mesh import FLASH as FlashAMR
from fava_tpu_torch.mesh import FlashParticles, FlashUniform
from fava_tpu_torch.models.model import Model


class FileSubStem(Enum):
    CHK = "chk"
    PLT = "plt_cnt"
    PRT = "part"
    UNI = "uniform"
    ANL = "analysis"


class FileType(Enum):
    CHK = 0
    PLT = 1
    PRT = 2
    CHK_PRT = 3
    PLT_PRT = 4
    UNI = 5
    ANL = 6


_PATTERNS = {
    FileType.CHK: ("*hdf5_chk_????", "hdf5_chk_"),
    FileType.PLT: ("*hdf5_plt_cnt_????", "hdf5_plt_cnt_"),
    FileType.PRT: ("*hdf5_part_????", "hdf5_part_"),
    FileType.UNI: ("*hdf5_uniform_????", "hdf5_uniform_"),
    FileType.ANL: ("*hdf5_analysis_????", "hdf5_analysis_"),
}


def _file_type(file_type: FileType | str) -> FileType:
    return file_type if isinstance(file_type, FileType) else FileType[str(file_type).upper()]


class FLASH(Model):
    """Model over a directory of FLASH output files, computing on ``device``."""

    def __init__(self, directory: str | Path, name: Optional[str] = None, device="cuda") -> None:
        super().__init__(directory, name, device)
        self.mesh = None
        self.particles = None

    def _directory_changed(self) -> None:
        def catalog(ftype: FileType) -> Dict[str, Dict[int, Path]]:
            pattern, splitter = _PATTERNS[ftype]
            # The ???? glob matches any 4 chars: skip non-numeric suffixes.
            files = [
                p
                for p in self._filter_files(pattern)
                if str(p).split(splitter)[-1].isdigit()
            ]
            return {
                "by number": {int(str(p).split(splitter)[-1]): p for p in files},
                "by index": dict(enumerate(files)),
            }

        self.chk_files = catalog(FileType.CHK)
        self.plt_files = catalog(FileType.PLT)
        self.prt_files = catalog(FileType.PRT)
        self.uni_files = catalog(FileType.UNI)
        self.anl_files = catalog(FileType.ANL)

    def _catalog(self, ftype: FileType) -> Dict[str, Dict[int, Path]]:
        return {
            FileType.CHK: self.chk_files,
            FileType.PLT: self.plt_files,
            FileType.PRT: self.prt_files,
            FileType.UNI: self.uni_files,
            FileType.ANL: self.anl_files,
        }[ftype]

    def nfiles(self, file_type: FileType | str = FileType.CHK, **kwargs) -> int:
        """Number of files of ``file_type``; other keywords are taken and
        ignored, as fava_tpu does."""
        return len(self._catalog(_file_type(file_type))["by index"])

    def load(
        self,
        file_index: int = 0,
        file_number: Optional[int] = None,
        file_type: FileType | str = FileType.CHK,
        fields=None,
        *args,
        **kwargs,
    ) -> None:
        """Load one file of the ``file_type`` catalog; extra arguments go
        to the particle loader (``ordered=``)."""
        ftype = _file_type(file_type)
        lookup = "by index" if file_number is None else "by number"
        key = file_index if file_number is None else file_number

        # The old mesh's device fields go before the new ones come.
        self.mesh = None
        self.particles = None

        def resolve(base: FileType) -> Path:
            catalog = self._catalog(base)
            if key not in catalog[lookup]:
                raise ValueError(f"{ftype.name} file {lookup} {key} not found")
            return catalog[lookup][key]

        def attach_mesh(base: FileType, mesh_cls) -> Path:
            path = resolve(base)
            self.mesh = mesh_cls(filename=path, device=self.device)
            self.mesh.load()
            if fields:
                self.mesh.load_data(names=fields)
            return path

        def attach_particles(path: Path) -> None:
            particle_kwargs = dict(kwargs)
            if fields is not None:
                particle_kwargs["fields"] = fields
            self.particles = FlashParticles(filename=path, device=self.device)
            self.particles._load_particles(*args, **particle_kwargs)

        match ftype:
            case FileType.CHK | FileType.PLT:
                attach_mesh(ftype, FlashAMR)
            case FileType.UNI:
                attach_mesh(FileType.UNI, FlashUniform)
            case FileType.PRT:
                attach_particles(resolve(FileType.PRT))
            case FileType.CHK_PRT:
                # Checkpoint files carry the particle table themselves.
                attach_particles(attach_mesh(FileType.CHK, FlashAMR))
            case FileType.PLT_PRT:
                attach_mesh(FileType.PLT, FlashAMR)
                attach_particles(resolve(FileType.PRT))
            case _:
                raise ValueError(f"Cannot load file type {ftype}")

    def convert_filename_type(
        self, current_filetype: FileType | str, new_filetype: FileType | str
    ) -> Optional[Path]:
        """The loaded mesh's filename with its ``hdf5_<type>_`` marker
        swapped for another type's (None when nothing is loaded)."""
        if self.mesh is None:
            return None

        def substem(ft: FileType) -> str:
            # Combined mesh+particle types convert via their mesh substem.
            name = ft.name[:-4] if ft.name.endswith("_PRT") else ft.name
            return FileSubStem[name].value

        curr, new = _file_type(current_filetype), _file_type(new_filetype)
        current_stem = self.mesh.filename.stem
        new_stem = current_stem.replace(f"hdf5_{substem(curr)}_", f"hdf5_{substem(new)}_")
        return self.mesh.filename.with_stem(new_stem)
