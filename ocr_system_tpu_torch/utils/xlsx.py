"""Minimal XLSX writer on stdlib zipfile — no openpyxl in the image.

Port of ``ocr_system_tpu/utils/xlsx.py``: the same code, on the port's modules.

Supports what the export service needs (reference export_service.py:168-306
uses openpyxl for styled sheets): multiple worksheets, bold header rows,
solid-fill cell colors (confidence tiers), column widths, numbers vs strings.
XLSX is a zip of XML parts; cells use inline strings so no shared-string
table is needed.
"""

from __future__ import annotations

import io
import re
import zipfile
from dataclasses import dataclass, field

_XML_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}
_ILLEGAL_XML_RE = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f]")


def _esc(s: str) -> str:
    s = _ILLEGAL_XML_RE.sub("", str(s))
    return "".join(_XML_ESCAPES.get(c, c) for c in s)


@dataclass
class Cell:
    value: object
    style: int = 0  # index into Workbook.styles fills


def col_letter(idx: int) -> str:
    """0-based column index -> A, B, ..., AA."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(65 + rem) + out
    return out


@dataclass
class Sheet:
    name: str
    rows: list[list[Cell]] = field(default_factory=list)
    col_widths: dict[int, float] = field(default_factory=dict)

    def add_row(self, values: list, styles: list[int] | None = None) -> None:
        styles = styles or [0] * len(values)
        self.rows.append([Cell(v, s) for v, s in zip(values, styles)])


class Workbook:
    """Styles: 0=default, 1=bold header, 2=green fill, 3=yellow fill,
    4=red fill (confidence tiers, reference export_service.py:168-191)."""

    STYLE_DEFAULT = 0
    STYLE_HEADER = 1
    STYLE_GREEN = 2
    STYLE_YELLOW = 3
    STYLE_RED = 4

    def __init__(self):
        self.sheets: list[Sheet] = []

    def add_sheet(self, name: str) -> Sheet:
        # sheet names: <=31 chars, no []:*?/\
        clean = re.sub(r"[\[\]:*?/\\]", "_", name)[:31] or f"Sheet{len(self.sheets)+1}"
        sheet = Sheet(clean)
        self.sheets.append(sheet)
        return sheet

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", self._content_types())
            z.writestr("_rels/.rels", _RELS_ROOT)
            z.writestr("xl/workbook.xml", self._workbook_xml())
            z.writestr("xl/_rels/workbook.xml.rels", self._workbook_rels())
            z.writestr("xl/styles.xml", _STYLES_XML)
            for i, sheet in enumerate(self.sheets, 1):
                z.writestr(f"xl/worksheets/sheet{i}.xml", self._sheet_xml(sheet))
        return buf.getvalue()

    def _content_types(self) -> str:
        overrides = "".join(
            f'<Override PartName="/xl/worksheets/sheet{i}.xml" '
            f'ContentType="application/vnd.openxmlformats-officedocument.'
            f'spreadsheetml.worksheet+xml"/>'
            for i in range(1, len(self.sheets) + 1)
        )
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
            '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            '<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>'
            f"{overrides}</Types>"
        )

    def _workbook_xml(self) -> str:
        sheets = "".join(
            f'<sheet name="{_esc(s.name)}" sheetId="{i}" r:id="rId{i}"/>'
            for i, s in enumerate(self.sheets, 1)
        )
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
            f"<sheets>{sheets}</sheets></workbook>"
        )

    def _workbook_rels(self) -> str:
        rels = "".join(
            f'<Relationship Id="rId{i}" Type="http://schemas.openxmlformats.org/'
            f'officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i}.xml"/>'
            for i in range(1, len(self.sheets) + 1)
        )
        n = len(self.sheets) + 1
        rels += (
            f'<Relationship Id="rId{n}" Type="http://schemas.openxmlformats.org/'
            f'officeDocument/2006/relationships/styles" Target="styles.xml"/>'
        )
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
            f"{rels}</Relationships>"
        )

    def _sheet_xml(self, sheet: Sheet) -> str:
        cols = ""
        if sheet.col_widths:
            col_defs = "".join(
                f'<col min="{i + 1}" max="{i + 1}" width="{w}" customWidth="1"/>'
                for i, w in sorted(sheet.col_widths.items())
            )
            cols = f"<cols>{col_defs}</cols>"
        rows_xml = []
        for ri, row in enumerate(sheet.rows, 1):
            cells = []
            for ci, cell in enumerate(row):
                ref = f"{col_letter(ci)}{ri}"
                style = f' s="{cell.style}"' if cell.style else ""
                v = cell.value
                if isinstance(v, bool):
                    cells.append(f'<c r="{ref}"{style} t="b"><v>{int(v)}</v></c>')
                elif isinstance(v, (int, float)) and v == v:  # not NaN
                    cells.append(f'<c r="{ref}"{style}><v>{v}</v></c>')
                elif v is None or v != v:
                    cells.append(f'<c r="{ref}"{style}/>')
                else:
                    cells.append(
                        f'<c r="{ref}"{style} t="inlineStr">'
                        f"<is><t xml:space=\"preserve\">{_esc(v)}</t></is></c>"
                    )
            rows_xml.append(f'<row r="{ri}">{"".join(cells)}</row>')
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
            f'{cols}<sheetData>{"".join(rows_xml)}</sheetData></worksheet>'
        )


_RELS_ROOT = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/'
    '2006/relationships/officeDocument" Target="xl/workbook.xml"/></Relationships>'
)

# fills: none, none(header uses bold), green C6EFCE, yellow FFEB9C, red FFC7CE
_STYLES_XML = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
    '<fonts count="2"><font><sz val="11"/><name val="Calibri"/></font>'
    '<font><b/><sz val="11"/><color rgb="FFFFFFFF"/><name val="Calibri"/></font></fonts>'
    '<fills count="6"><fill><patternFill patternType="none"/></fill>'
    '<fill><patternFill patternType="gray125"/></fill>'
    '<fill><patternFill patternType="solid"><fgColor rgb="FF4472C4"/></patternFill></fill>'
    '<fill><patternFill patternType="solid"><fgColor rgb="FFC6EFCE"/></patternFill></fill>'
    '<fill><patternFill patternType="solid"><fgColor rgb="FFFFEB9C"/></patternFill></fill>'
    '<fill><patternFill patternType="solid"><fgColor rgb="FFFFC7CE"/></patternFill></fill></fills>'
    '<borders count="1"><border/></borders>'
    '<cellStyleXfs count="1"><xf/></cellStyleXfs>'
    '<cellXfs count="5">'
    "<xf/>"
    '<xf fontId="1" fillId="2" applyFont="1" applyFill="1"/>'
    '<xf fillId="3" applyFill="1"/>'
    '<xf fillId="4" applyFill="1"/>'
    '<xf fillId="5" applyFill="1"/>'
    "</cellXfs></styleSheet>"
)
