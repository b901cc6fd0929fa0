"""Table structure recovery from layout boxes.

BASELINE config 5 ("KV + table structure on TPU"): the reference gets table
cells for free from Azure prebuilt-layout (table/table-cell polygons,
ocr_service.py:248-376). The local equivalent reconstructs tables from the
detected word/line boxes by grid alignment — the standard geometry approach:

  1. cluster boxes into rows by y-overlap (reading-order grouping),
  2. find column anchors by clustering x-starts across rows,
  3. accept maximal row-runs where >= MIN_ROWS rows agree on >= MIN_COLS
     column anchors (a grid), emit cells + an Azure-shaped "table" layout box
     and a markdown table.

Host-side numpy/geometry — tiny data, control-flow heavy (SURVEY §7.3 split).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_ROWS = 2
MIN_COLS = 2
COL_TOLERANCE_RATIO = 0.8  # x-cluster width, relative to median char height


@dataclass
class TableCell:
    row: int
    col: int
    text: str
    polygon: list[float]


@dataclass
class Table:
    cells: list[TableCell]
    n_rows: int
    n_cols: int
    polygon: list[float]
    page_number: int = 1

    def to_markdown(self) -> str:
        grid = [["" for _ in range(self.n_cols)] for _ in range(self.n_rows)]
        for c in self.cells:
            if c.row < self.n_rows and c.col < self.n_cols:
                grid[c.row][c.col] = c.text
        lines = ["| " + " | ".join(row) + " |" for row in grid]
        sep = "| " + " | ".join(["---"] * self.n_cols) + " |"
        return "\n".join([lines[0], sep, *lines[1:]]) if lines else ""

    def to_layout_box(self) -> dict:
        return {
            "type": "table",
            "content": self.to_markdown(),
            "confidence": 0.9,
            "polygon": self.polygon,
            "page_number": self.page_number,
            "row_count": self.n_rows,
            "column_count": self.n_cols,
        }


def _rows_from_boxes(boxes: list[dict]) -> list[list[dict]]:
    """Group word boxes into rows by y-center proximity (same algorithm as
    reading order, tolerance 0.5 x avg height)."""
    if not boxes:
        return []
    items = []
    for b in boxes:
        poly = b.get("polygon", [])
        if len(poly) < 8:
            continue
        ys = poly[1::2]
        xs = poly[0::2]
        items.append(
            (min(xs), (min(ys) + max(ys)) / 2.0, max(ys) - min(ys), b)
        )
    if not items:
        return []
    avg_h = float(np.mean([h for _, _, h, _ in items])) or 1.0
    items.sort(key=lambda t: t[1])
    rows: list[list] = [[items[0]]]
    # running mean as an incremental sum (the per-append np.mean over the
    # whole row was O(row^2) tiny-array calls — ~30 us x every box on the
    # 1-core serving host)
    row_sum, row_n = items[0][1], 1
    for it in items[1:]:
        if abs(it[1] - row_sum / row_n) <= 0.5 * avg_h:
            rows[-1].append(it)
            row_sum += it[1]
            row_n += 1
        else:
            rows.append([it])
            row_sum, row_n = it[1], 1
    return [[t[3] for t in sorted(r, key=lambda t: t[0])] for r in rows]


def _x_starts(row: list[dict]) -> list[float]:
    return [min(b["polygon"][0::2]) for b in row]


def find_tables(word_boxes: list[dict], page_number: int = 1) -> list[Table]:
    """Detect grid-aligned regions among word boxes of ONE page."""
    boxes = [
        b for b in word_boxes
        if b.get("type") == "word" and b.get("page_number", 1) == page_number
    ]
    rows = _rows_from_boxes(boxes)
    if len(rows) < MIN_ROWS:
        return []

    heights = [
        max(b["polygon"][1::2]) - min(b["polygon"][1::2])
        for r in rows for b in r
    ]
    tol = max(float(np.median(heights)) * COL_TOLERANCE_RATIO, 4.0)

    tables: list[Table] = []
    i = 0
    while i < len(rows) - 1:
        # grow a run of consecutive rows sharing column anchors
        anchors = _x_starts(rows[i])
        run = [i]
        for j in range(i + 1, len(rows)):
            xs = _x_starts(rows[j])
            matched = _match_anchors(anchors, xs, tol)
            if len(matched) >= MIN_COLS:
                anchors = matched
                run.append(j)
            else:
                break
        if len(run) >= MIN_ROWS and len(anchors) >= MIN_COLS:
            tables.append(_build_table(rows, run, anchors, tol, page_number))
            i = run[-1] + 1
        else:
            i += 1
    return tables


def _match_anchors(a: list[float], b: list[float], tol: float) -> list[float]:
    """Column anchors present (within tol) in both lists."""
    out = []
    for x in a:
        close = [y for y in b if abs(y - x) <= tol]
        if close:
            out.append((x + min(close, key=lambda y: abs(y - x))) / 2.0)
    return out


def _build_table(
    rows: list[list[dict]], run: list[int], anchors: list[float],
    tol: float, page_number: int,
) -> Table:
    anchors = sorted(anchors)
    cells: list[TableCell] = []
    all_x: list[float] = []
    all_y: list[float] = []
    for r_i, row_idx in enumerate(run):
        # merge row words into cells by nearest anchor
        buckets: dict[int, list[dict]] = {}
        for b in rows[row_idx]:
            x0 = min(b["polygon"][0::2])
            # anchors is short (<=~10 cols): plain-Python nearest beats a
            # temporary list + np.argmin per box
            col = min(range(len(anchors)), key=lambda k: abs(x0 - anchors[k]))
            # words right of their anchor but before the next anchor also
            # belong to that column
            while col + 1 < len(anchors) and x0 >= anchors[col + 1] - tol:
                col += 1
            buckets.setdefault(col, []).append(b)
        for col, cell_boxes in buckets.items():
            cell_boxes.sort(key=lambda b: min(b["polygon"][0::2]))
            text = " ".join(b.get("content", "") for b in cell_boxes)
            xs = [v for b in cell_boxes for v in b["polygon"][0::2]]
            ys = [v for b in cell_boxes for v in b["polygon"][1::2]]
            all_x += xs
            all_y += ys
            cells.append(
                TableCell(
                    row=r_i, col=col, text=text,
                    polygon=[min(xs), min(ys), max(xs), min(ys),
                             max(xs), max(ys), min(xs), max(ys)],
                )
            )
    x0, x1 = min(all_x), max(all_x)
    y0, y1 = min(all_y), max(all_y)
    return Table(
        cells=cells,
        n_rows=len(run),
        n_cols=len(anchors),
        polygon=[x0, y0, x1, y0, x1, y1, x0, y1],
        page_number=page_number,
    )


def extract_table_fields(tables: list[Table]) -> list:
    """Tables -> ExtractedFields of type 'table' (markdown value), matching
    how the reference persists Azure tables through the Gemini path."""
    from ocr_system_tpu_torch.extract.types import ExtractedField

    return [
        ExtractedField(
            field_key=f"Table {i + 1}",
            field_value=t.to_markdown(),
            field_type="table",
            confidence=0.9,
        )
        for i, t in enumerate(tables)
    ]
