"""Minimal, dependency-free .xlsx reader and writer (a copy of
``utils/xlsx.py``'s ``write_xlsx``/``write_xlsx_sheets``/``read_xlsx`` on
lists of row dicts in place of a ``DataFrame``).

A workbook is a zip of XML parts; cells are written as inline strings or
numbers (no sharedStrings table), and both inline and shared strings are
parsed on read.  The XML written and the number coercion read are the
reference's.  A sheet is ``(columns, rows)``: an explicit column list and
row dicts keyed by it (a missing key is an empty cell).

    write_xlsx(columns, rows, path, sheet_name="Sheet1")
    write_xlsx_sheets({name: (columns, rows), ...}, path)
    read_xlsx(path, sheet=0) -> (columns, rows)
    append_xlsx(columns, rows, path) -> combined rows
"""

from __future__ import annotations

import math
import os
import re
import tempfile
import zipfile
from typing import Dict, List, Sequence, Tuple
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheet_overrides}</Types>
"""

_SHEET_OVERRIDE = '<Override PartName="/xl/worksheets/sheet{i}.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>\n'

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>
"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>{sheets}</sheets>
</workbook>
"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}</Relationships>
"""

# Characters illegal in XML 1.0 (except tab/newline/CR): stripped on write.
_ILLEGAL_XML = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f]")

Sheet = Tuple[Sequence[str], Sequence[Dict]]


def _col_letter(idx: int) -> str:
    """0-based column index -> A1-style letters."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, float) and math.isnan(value):
        return ""
    if isinstance(value, (bool, np.bool_)):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, np.integer)):
        return f'<c r="{ref}"><v>{int(value)}</v></c>'
    if isinstance(value, (float, np.floating)):
        if math.isinf(value):
            # no inf literal in a workbook: stored as its text
            text = "inf" if value > 0 else "-inf"
            return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'
        return f'<c r="{ref}"><v>{float(value)!r}</v></c>'
    text = escape(_ILLEGAL_XML.sub("", str(value)))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def _sheet_xml(columns: Sequence[str], rows: Sequence[Dict]) -> str:
    rows_xml = []
    header_cells = "".join(
        _cell_xml(f"{_col_letter(c)}1", col) for c, col in enumerate(columns))
    rows_xml.append(f'<row r="1">{header_cells}</row>')
    for r, row in enumerate(rows, start=2):
        cells = "".join(
            _cell_xml(f"{_col_letter(c)}{r}", row.get(col))
            for c, col in enumerate(columns))
        rows_xml.append(f'<row r="{r}">{cells}</row>')
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f'<sheetData>{"".join(rows_xml)}</sheetData></worksheet>'
    )


def write_xlsx_sheets(sheets: Dict[str, Sheet], path) -> None:
    """Write a workbook with one worksheet per ``name: (columns, rows)``
    entry, in order; ``read_xlsx(path, sheet=i)`` reads them back by
    position.  The write is atomic (a sibling temp file, then
    ``os.replace``), so a crash mid-write never truncates an existing
    workbook."""
    if not sheets:
        raise ValueError("write_xlsx_sheets needs at least one sheet")
    names = [escape(str(n)[:31]) for n in sheets]
    sheet_tags = "".join(
        f'<sheet name="{n}" sheetId="{i}" r:id="rId{i}"/>'
        for i, n in enumerate(names, start=1)
    )
    rels = "".join(
        f'<Relationship Id="rId{i}" Type="http://schemas.openxmlformats.org/'
        f'officeDocument/2006/relationships/worksheet" Target="worksheets/sheet{i}.xml"/>\n'
        for i in range(1, len(names) + 1)
    )
    overrides = "".join(_SHEET_OVERRIDE.format(i=i) for i in range(1, len(names) + 1))
    path = str(path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".xlsx.tmp")
    os.close(fd)
    # mkstemp creates 0600: keep the destination's mode, or the umask's
    if os.path.exists(path):
        os.chmod(tmp, os.stat(path).st_mode & 0o777)
    else:
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("[Content_Types].xml",
                        _CONTENT_TYPES.format(sheet_overrides=overrides))
            zf.writestr("_rels/.rels", _RELS)
            zf.writestr("xl/workbook.xml", _WORKBOOK.format(sheets=sheet_tags))
            zf.writestr("xl/_rels/workbook.xml.rels",
                        _WORKBOOK_RELS.format(rels=rels))
            for i, (columns, rows) in enumerate(sheets.values(), start=1):
                zf.writestr(f"xl/worksheets/sheet{i}.xml",
                            _sheet_xml(columns, rows))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def write_xlsx(columns: Sequence[str], rows: Sequence[Dict], path,
               sheet_name: str = "Sheet1") -> None:
    write_xlsx_sheets({sheet_name: (columns, rows)}, path)


def _parse_shared_strings(zf: zipfile.ZipFile):
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ET.fromstring(data)
    return ["".join(t.text or "" for t in si.iter(f"{_NS}t"))
            for si in root.findall(f"{_NS}si")]


def _cell_ref_to_col(ref: str) -> int:
    col = 0
    for ch in ref:
        if ch.isalpha():
            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return col - 1


def _coerce_number(text: str):
    try:
        f = float(text)
    except ValueError:
        return text
    if f.is_integer() and "." not in text and "e" not in text.lower():
        return int(f)
    return f


def read_xlsx(path, sheet: int = 0) -> Tuple[List[str], List[Dict]]:
    """``(columns, rows)`` of one worksheet: the header row's names (an
    empty header cell reads ``"Unnamed: <i>"``) and one dict a later row,
    with ``None`` for an empty cell."""
    with zipfile.ZipFile(path) as zf:
        shared = _parse_shared_strings(zf)
        sheet_names = sorted(
            (n for n in zf.namelist() if re.match(r"xl/worksheets/sheet\d+\.xml$", n)),
            key=lambda n: int(re.search(r"(\d+)\.xml$", n).group(1)),
        )
        if not sheet_names:
            raise ValueError(f"no worksheets in {path}")
        root = ET.fromstring(zf.read(sheet_names[sheet]))
    raw_rows = []
    max_col = 0
    for row in root.iter(f"{_NS}row"):
        cells = {}
        for c in row.findall(f"{_NS}c"):
            ref = c.get("r", "")
            col = _cell_ref_to_col(ref) if ref else len(cells)
            ctype = c.get("t", "n")
            value = None
            if ctype == "inlineStr":
                is_el = c.find(f"{_NS}is")
                if is_el is not None:
                    value = "".join(t.text or "" for t in is_el.iter(f"{_NS}t"))
            else:
                v = c.find(f"{_NS}v")
                if v is not None and v.text is not None:
                    if ctype == "s":
                        value = shared[int(v.text)]
                    elif ctype == "b":
                        value = bool(int(v.text))
                    elif ctype == "str":
                        value = v.text
                    else:
                        value = _coerce_number(v.text)
            cells[col] = value
            max_col = max(max_col, col + 1)
        raw_rows.append(cells)
    if not raw_rows:
        return [], []
    header = [raw_rows[0].get(i) for i in range(max_col)]
    header = [h if h is not None else f"Unnamed: {i}" for i, h in enumerate(header)]
    rows = [{h: r.get(i) for i, h in enumerate(header)} for r in raw_rows[1:]]
    return header, rows


def append_xlsx(columns: Sequence[str], rows: Sequence[Dict], path) -> List[Dict]:
    """Append ``rows`` to the workbook at ``path`` (if any) and rewrite it;
    returns the combined rows.  The columns are the existing sheet's, then
    any of ``columns`` it lacks (the column union ``pandas.concat``
    takes); an empty existing sheet gives way to ``columns``."""
    rows = list(rows)
    if os.path.exists(path):
        old_columns, old_rows = read_xlsx(path)
        if old_rows:
            columns = list(old_columns) + [c for c in columns
                                           if c not in old_columns]
            rows = old_rows + rows
    write_xlsx(columns, rows, path)
    return rows
