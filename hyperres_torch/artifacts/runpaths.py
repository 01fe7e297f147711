# Port-owned copy of hyperres/artifacts/runpaths.py (ensure_dir :13,
# RunPaths :20), verbatim apart from this header.
"""Per-pair run folder layout — schema parity with the reference's
``RunPaths`` (documentation/pairs_artifacts.py:45-150): emit/, s2/,
emit_utm/, plots/, tiles/, metadata/tiles/, report.md, manifest.csv,
with an optional mirrored archive ("drive") tree."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union


def ensure_dir(p: Union[str, Path]) -> Path:
    p = Path(p)
    p.mkdir(parents=True, exist_ok=True)
    return p


@dataclass(frozen=True)
class RunPaths:
    run_id: str

    local_root: Path
    local_emit: Path
    local_s2: Path
    local_emit_utm: Path
    local_plots: Path
    local_tiles: Path
    local_meta: Path
    local_tile_meta: Path
    local_report_md: Path
    local_manifest_csv: Path

    drive_root: Optional[Path] = None
    drive_emit: Optional[Path] = None
    drive_s2: Optional[Path] = None
    drive_emit_utm: Optional[Path] = None
    drive_plots: Optional[Path] = None
    drive_tiles: Optional[Path] = None
    drive_meta: Optional[Path] = None
    drive_tile_meta: Optional[Path] = None
    drive_report_md: Optional[Path] = None
    drive_manifest_csv: Optional[Path] = None

    @staticmethod
    def emit_id_from_nc(emit_nc: Union[str, Path]) -> str:
        """run_id from the EMIT granule stem (pairs_artifacts.py:77-80)."""
        return Path(emit_nc).stem.replace("EMIT_L2A_RFL_", "", 1)

    @classmethod
    def build(cls, *, emit_nc: Union[str, Path],
              local_root: Union[str, Path],
              drive_base: Union[str, Path, None] = None) -> "RunPaths":
        run_id = cls.emit_id_from_nc(emit_nc)

        local_root = ensure_dir(local_root)
        local = dict(
            local_root=local_root,
            local_emit=ensure_dir(local_root / "emit"),
            local_s2=ensure_dir(local_root / "s2"),
            local_emit_utm=ensure_dir(local_root / "emit_utm"),
            local_plots=ensure_dir(local_root / "plots"),
            local_tiles=ensure_dir(local_root / "tiles"),
            local_meta=ensure_dir(local_root / "metadata"),
            local_tile_meta=ensure_dir(local_root / "metadata" / "tiles"),
            local_report_md=local_root / "report.md",
            local_manifest_csv=local_root / "manifest.csv",
        )
        if drive_base is None:
            return cls(run_id=run_id, **local)

        drive_root = ensure_dir(Path(drive_base) / run_id)
        return cls(
            run_id=run_id, **local,
            drive_root=drive_root,
            drive_emit=ensure_dir(drive_root / "emit"),
            drive_s2=ensure_dir(drive_root / "s2"),
            drive_emit_utm=ensure_dir(drive_root / "emit_utm"),
            drive_plots=ensure_dir(drive_root / "plots"),
            drive_tiles=ensure_dir(drive_root / "tiles"),
            drive_meta=ensure_dir(drive_root / "metadata"),
            drive_tile_meta=ensure_dir(drive_root / "metadata" / "tiles"),
            drive_report_md=drive_root / "report.md",
            drive_manifest_csv=drive_root / "manifest.csv",
        )
