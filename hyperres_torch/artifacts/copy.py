# Port-owned copy of hyperres/artifacts/copy.py (copy_any :15), verbatim
# apart from this header.
"""Archival copy utility — copy_any parity
(documentation/pairs_artifacts.py:626-682): rsync when available, pure
shutil fallback, overwrite/exclude semantics."""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Union

from .runpaths import ensure_dir


def copy_any(
    src: Union[str, Path],
    dst: Union[str, Path],
    *,
    overwrite: bool = False,
    use_rsync: bool = True,
    exclude: Optional[List[str]] = None,
) -> None:
    src = Path(src)
    dst = Path(dst)
    if not src.exists():
        raise FileNotFoundError(f"Source does not exist: {src}")
    exclude = exclude or []

    if src.is_file():
        ensure_dir(dst.parent)
    else:
        ensure_dir(dst)

    if use_rsync and shutil.which("rsync"):
        try:
            cmd = ["rsync", "-a"]
            if not overwrite:
                cmd += ["--ignore-existing"]
            for pat in exclude:
                cmd += ["--exclude", pat]
            if src.is_dir():
                cmd += [str(src) + "/", str(dst) + "/"]
            else:
                cmd += [str(src), str(dst)]
            subprocess.run(cmd, check=True, capture_output=True)
            return
        except Exception:
            pass

    def _excluded(name: str) -> bool:
        from fnmatch import fnmatch
        return any(fnmatch(name, pat) for pat in exclude)

    if src.is_dir():
        for item in src.iterdir():
            if _excluded(item.name):
                continue
            target = dst / item.name
            if item.is_dir():
                if target.exists() and overwrite:
                    shutil.rmtree(target)
                if not target.exists():
                    shutil.copytree(item, target)
                else:
                    # MERGE new files into an existing directory — the
                    # rsync --ignore-existing semantics (re-archiving a
                    # run after more tiles were produced must copy them)
                    copy_any(item, target, overwrite=overwrite,
                             use_rsync=False, exclude=exclude)
            else:
                if target.exists() and not overwrite:
                    continue
                shutil.copy2(item, target)
    else:
        target = (dst / src.name) if dst.is_dir() else dst
        if target.exists() and not overwrite:
            return
        ensure_dir(target.parent)
        shutil.copy2(src, target)
