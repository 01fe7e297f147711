# Port-owned copy of hyperres/artifacts/report.py (utc_now_iso :13,
# ReportWriter :17), verbatim apart from this header.
"""Markdown run report — ReportWriter parity
(documentation/pairs_artifacts.py:162-200)."""

from __future__ import annotations

import datetime as dt
from pathlib import Path
from typing import Iterable, Union

from .runpaths import ensure_dir


def utc_now_iso() -> str:
    return dt.datetime.now(dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class ReportWriter:
    def __init__(self, path: Union[str, Path], *, mode: str = "overwrite"):
        self.path = Path(path)
        ensure_dir(self.path.parent)
        self.mode = mode
        self._started = False

    def start(self, *, title: str = "EMIT and Sentinel-2 pairs report"
              ) -> "ReportWriter":
        if self._started:
            return self
        overwrite = self.mode.lower() in {"overwrite", "w", "write"}
        if overwrite or not self.path.exists():
            self.path.write_text(
                f"# {title}\n\n- Generated: {utc_now_iso()}\n")
        self._started = True
        return self

    def section(self, heading: str, lines: Iterable[str]) -> None:
        if not self._started:
            self.start()
        with self.path.open("a", encoding="utf-8") as f:
            f.write(f"\n## {heading}\n")
            for ln in lines:
                if ln is None:
                    continue
                f.write(f"- {ln}\n")

    def raw(self, text: str) -> None:
        if not self._started:
            self.start()
        with self.path.open("a", encoding="utf-8") as f:
            f.write(text)
