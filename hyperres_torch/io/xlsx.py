# Port-owned copy of hyperres/io/xlsx.py (line 1), verbatim apart from read_table's
# coercion of numeric-string cells (see its docstring).
"""Minimal XLSX (OOXML spreadsheet) codec — read + write, stdlib only.

The measured-SRF import path consumes the official Copernicus workbook
(reference: s2_emit/srf.py:6-9 downloads it and reads it with
pandas+openpyxl on every run). This environment — and any offline
production image — need not carry an Excel stack for that one table, so
this module implements the minimal subset of the format directly on
``zipfile`` + ``xml.etree``: an .xlsx file is a zip archive holding
workbook/worksheet XML parts wired together by relationship files.

Reader supports what real-world workbooks use for tabular data: shared
strings, inline strings, formula-cached strings, numbers, booleans,
blank gaps in sparse rows, and arbitrary sheet count. Writer emits
inline-string headers + numeric cells — enough to round-trip the SRF
tables and to fabricate workbook-shaped fixtures for tests.

Same own-codec policy as the rest of the package's ``io`` (GeoTIFF, ENVI,
HDF5): no GDAL-sized dependency for a KB-scale format need.
"""

from __future__ import annotations

import re
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union
from xml.etree import ElementTree as ET

import numpy as np

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_NS_REL = ("{http://schemas.openxmlformats.org/package/2006/"
           "relationships}")
_NS_DOCREL = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
              "relationships}")


def _col_index(cell_ref: str) -> int:
    """'A1' -> 0, 'AB12' -> 27 (0-based column from an A1 reference)."""
    m = re.match(r"([A-Z]+)", cell_ref)
    if not m:
        return 0
    idx = 0
    for ch in m.group(1):
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def _read_shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ET.fromstring(data)
    out = []
    for si in root.findall(f"{_NS}si"):
        # either one <t> or rich-text runs <r><t>; concatenate all <t>
        out.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
    return out


def _sheet_paths(zf: zipfile.ZipFile) -> Dict[str, str]:
    """Sheet name -> worksheet part path inside the archive."""
    wb = ET.fromstring(zf.read("xl/workbook.xml"))
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    rid_to_target = {
        r.get("Id"): r.get("Target")
        for r in rels.findall(f"{_NS_REL}Relationship")
    }
    out: Dict[str, str] = {}
    for sh in wb.iter(f"{_NS}sheet"):
        rid = sh.get(f"{_NS_DOCREL}id")
        target = rid_to_target.get(rid)
        if target is None:
            continue
        if not target.startswith("/"):
            target = "xl/" + target
        else:
            target = target.lstrip("/")
        out[sh.get("name", "")] = target
    return out


def _cell_value(c: ET.Element, shared: List[str]):
    t = c.get("t", "n")
    if t == "inlineStr":
        is_el = c.find(f"{_NS}is")
        if is_el is None:
            return None
        return "".join(x.text or "" for x in is_el.iter(f"{_NS}t"))
    v = c.find(f"{_NS}v")
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t == "str":
        return v.text
    if t == "b":
        return bool(int(v.text))
    try:
        return float(v.text)
    except ValueError:
        return v.text


def sheet_names(path: Union[str, Path]) -> List[str]:
    with zipfile.ZipFile(path) as zf:
        return list(_sheet_paths(zf))


def read_sheet(path: Union[str, Path],
               sheet: Optional[str] = None) -> List[List[object]]:
    """Read one worksheet as a dense list of rows (None for blanks).

    ``sheet``: exact sheet name, or None for the first sheet."""
    with zipfile.ZipFile(path) as zf:
        paths = _sheet_paths(zf)
        if not paths:
            raise ValueError(f"No worksheets in {path}")
        if sheet is None:
            target = next(iter(paths.values()))
        elif sheet in paths:
            target = paths[sheet]
        else:
            raise KeyError(
                f"Sheet {sheet!r} not in {path} (has {list(paths)})")
        shared = _read_shared_strings(zf)
        root = ET.fromstring(zf.read(target))
        rows: List[List[object]] = []
        ncols = 0
        for row in root.iter(f"{_NS}row"):
            vals: Dict[int, object] = {}
            for c in row.findall(f"{_NS}c"):
                ref = c.get("r", "")
                j = _col_index(ref) if ref else len(vals)
                vals[j] = _cell_value(c, shared)
            width = (max(vals) + 1) if vals else 0
            ncols = max(ncols, width)
            rows.append([vals.get(j) for j in range(width)])
        for r in rows:
            r.extend([None] * (ncols - len(r)))
        return rows


def read_table(path: Union[str, Path], sheet: Optional[str] = None
               ) -> Tuple[List[str], np.ndarray]:
    """Read a header-row table: (column names, float64 matrix with NaN
    for blanks/non-numeric cells) — the shape pandas' ``parse`` +
    ``to_numeric(errors='coerce')`` would give the SRF loader. A string
    cell that holds a number (a workbook that stores ``"0.25"`` as text)
    is coerced to that number, as ``to_numeric`` does; the reference's
    reader (``xlsx.py:158``) drops such cells to NaN."""
    rows = read_sheet(path, sheet)
    if not rows:
        return [], np.zeros((0, 0), dtype=np.float64)
    header = ["" if v is None else str(v) for v in rows[0]]
    body = rows[1:]
    out = np.full((len(body), len(header)), np.nan, dtype=np.float64)
    for i, r in enumerate(body):
        for j, v in enumerate(r[: len(header)]):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[i, j] = float(v)
            elif isinstance(v, str) and "_" not in v:
                try:
                    out[i, j] = float(v)
                except ValueError:
                    pass
    return header, out


# ---------------------------------------------------------------------------
# Writer (fixtures + re-export of imported tables)
# ---------------------------------------------------------------------------

_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
    'content-types">'
    '<Default Extension="rels" ContentType="application/vnd.'
    'openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/'
    'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    "{sheet_overrides}"
    "</Types>"
)

_ROOT_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/'
    '2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
    'officeDocument/2006/relationships/officeDocument" '
    'Target="xl/workbook.xml"/></Relationships>'
)


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _sheet_xml(header: Sequence[str], data: np.ndarray) -> str:
    def cell_ref(i, j):
        letters = ""
        j += 1
        while j:
            j, rem = divmod(j - 1, 26)
            letters = chr(ord("A") + rem) + letters
        return f"{letters}{i + 1}"

    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
    ]
    cells = "".join(
        f'<c r="{cell_ref(0, j)}" t="inlineStr"><is><t>{_esc(h)}</t>'
        "</is></c>" for j, h in enumerate(header))
    parts.append(f'<row r="1">{cells}</row>')
    arr = np.asarray(data, dtype=np.float64)
    for i in range(arr.shape[0]):
        row_cells = []
        for j in range(arr.shape[1]):
            v = arr[i, j]
            if np.isfinite(v):
                row_cells.append(
                    f'<c r="{cell_ref(i + 1, j)}"><v>{float(v)!r}</v>'
                    "</c>")
        parts.append(f'<row r="{i + 2}">{"".join(row_cells)}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def write_xlsx(path: Union[str, Path],
               sheets: Dict[str, Tuple[Sequence[str], np.ndarray]]
               ) -> Path:
    """Write ``{sheet_name: (header, float matrix)}`` as a minimal
    .xlsx (NaN cells are left blank, matching how the Copernicus
    workbook leaves out-of-support wavelengths empty)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(sheets)
    sheet_entries = "".join(
        f'<sheet name="{_esc(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i, n in enumerate(names))
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" xmlns:r="http://schemas.'
        'openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{sheet_entries}</sheets></workbook>")
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/'
        'package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships/'
            f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(len(names)))
        + "</Relationships>")
    overrides = "".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
        'ContentType="application/vnd.openxmlformats-officedocument.'
        'spreadsheetml.worksheet+xml"/>' for i in range(len(names)))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml",
                    _CONTENT_TYPES.format(sheet_overrides=overrides))
        zf.writestr("_rels/.rels", _ROOT_RELS)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, n in enumerate(names):
            header, data = sheets[n]
            zf.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                        _sheet_xml(header, data))
    return path
