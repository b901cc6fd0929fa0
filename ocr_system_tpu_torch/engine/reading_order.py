"""Reading-order postprocessing: detected word boxes -> ordered lines -> text.

Implements the algorithm SURVEY.md §2.1 #17 flags as required for any local
det+rec stack (reference: backend/utils/ocr_postprocessor.py):
  - sort blocks by y-center                               (:101-143)
  - group into lines by y-overlap within 0.5 * avg height (:118-127)
  - sort within each line by x, merge text, average conf  (:146-182)

The reference parses RapidOCR tuples; here the input is the framework's own
(quad, text, confidence) triples from the rec stage.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TextBlock:
    """One recognized region (reference TextBlock, ocr_postprocessor.py:20-39)."""

    quad: np.ndarray  # (4, 2) float32
    text: str
    confidence: float

    @property
    def y_center(self) -> float:
        return float(self.quad[:, 1].mean())

    @property
    def x_min(self) -> float:
        return float(self.quad[:, 0].min())

    @property
    def height(self) -> float:
        return float(self.quad[:, 1].max() - self.quad[:, 1].min())


@dataclasses.dataclass
class MergedLine:
    """One reading-order line (reference MergedLine, ocr_postprocessor.py:42-48)."""

    text: str
    confidence: float
    blocks: list[TextBlock]

    @property
    def quad(self) -> np.ndarray:
        pts = np.concatenate([b.quad for b in self.blocks], axis=0)
        x0, y0 = pts[:, 0].min(), pts[:, 1].min()
        x1, y1 = pts[:, 0].max(), pts[:, 1].max()
        return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], dtype=np.float32)


def group_into_lines(
    blocks: list[TextBlock], tolerance_ratio: float = 0.5
) -> list[list[TextBlock]]:
    """Group by y-center proximity: a block joins the current line when its
    y-center is within tolerance = tolerance_ratio * avg_height of the line's
    running y-center (reference ocr_postprocessor.py:101-143)."""
    if not blocks:
        return []
    # one vectorized pass for y-centers/heights: the per-block property
    # calls (tiny numpy means inside the clustering loop) were the top
    # _finish_page cost after selection marks (~16 ms/page profiled r4)
    quads = np.stack([b.quad for b in blocks])
    yc = quads[:, :, 1].mean(axis=1, dtype=np.float64)
    heights = quads[:, :, 1].max(axis=1) - quads[:, :, 1].min(axis=1)
    avg_h = float(heights.mean()) or 1.0
    tol = tolerance_ratio * avg_h
    order = np.argsort(yc, kind="stable")
    first = int(order[0])
    lines: list[list[TextBlock]] = [[blocks[first]]]
    # running mean as an incremental sum (identical math, no list re-mean)
    line_sum, line_n = float(yc[first]), 1
    for idx in order[1:]:
        i = int(idx)
        if abs(float(yc[i]) - line_sum / line_n) <= tol:
            lines[-1].append(blocks[i])
            line_sum += float(yc[i])
            line_n += 1
        else:
            lines.append([blocks[i]])
            line_sum, line_n = float(yc[i]), 1
    return lines


def sort_and_merge_lines(lines: list[list[TextBlock]]) -> list[MergedLine]:
    """Within each line sort by x and merge text with confidence averaging
    (reference ocr_postprocessor.py:146-182)."""
    merged = []
    for line in lines:
        line = sorted(line, key=lambda b: b.x_min)
        text = " ".join(b.text for b in line if b.text)
        conf = (
            sum(b.confidence for b in line) / len(line) if line else 0.0
        )
        merged.append(MergedLine(text=text, confidence=conf, blocks=line))
    return merged


def order_blocks(blocks: list[TextBlock]) -> list[MergedLine]:
    """Fused grouping+merge: one stacked-quad pass computes y-centers,
    heights AND x-mins, so the per-line sort never touches the per-block
    numpy properties (x_min alone was ~1.2k tiny ndarray.min calls per
    serving wave on the 1-core host). Semantically identical to
    sort_and_merge_lines(group_into_lines(blocks))."""
    if not blocks:
        return []
    quads = np.stack([b.quad for b in blocks])
    yc = quads[:, :, 1].mean(axis=1, dtype=np.float64)
    heights = quads[:, :, 1].max(axis=1) - quads[:, :, 1].min(axis=1)
    xmin = quads[:, :, 0].min(axis=1)
    tol = 0.5 * (float(heights.mean()) or 1.0)
    order = np.argsort(yc, kind="stable")
    merged: list[MergedLine] = []
    line_idx: list[int] = []
    line_sum = 0.0

    def flush() -> None:
        if not line_idx:
            return
        line_idx.sort(key=lambda i: xmin[i])
        line = [blocks[i] for i in line_idx]
        text = " ".join(b.text for b in line if b.text)
        conf = sum(b.confidence for b in line) / len(line)
        merged.append(MergedLine(text=text, confidence=conf, blocks=line))

    for idx in order:
        i = int(idx)
        if line_idx and abs(float(yc[i]) - line_sum / len(line_idx)) <= tol:
            line_idx.append(i)
            line_sum += float(yc[i])
        else:
            flush()
            line_idx = [i]
            line_sum = float(yc[i])
    flush()
    return merged


def canonicalize_leaders(text: str) -> str:
    """Collapse dot-leader runs (>=3 '.') to a canonical '...'.

    Form rows pad 'Key ......... value' with as many dots as the column is
    wide; the recognizer reads the words correctly but the dot COUNT drifts
    with crop squeeze — a pure presentation artifact that dominated plain-
    page e2e CER (round-3 diagnosis: words decoded, dot counts didn't).
    The reference's markdown comes from Azure, which emits whatever glyph
    run the page carries (ocr_service.py:737-757) — collapsing at emission
    is a deliberate, documented improvement, applied identically to eval
    truth so it can't hide real errors. Runs broken by spaces ('. . .')
    collapse too."""
    import re

    # normalize spacing around the token too: a det row-merge decodes
    # 'Total.......42' with the dots glued to the words, while word-level
    # truth joins with spaces — both sides must land on 'Total ... 42'
    return re.sub(r"\s*\.(?:\s*\.){2,}\s*", " ... ", text).strip()


def to_markdown(lines: list[MergedLine]) -> str:
    """Plain reading-order text (the reference emits Azure's markdown; for the
    local engine each merged line becomes one markdown line). Dot-leader
    runs collapse to '...' (see canonicalize_leaders)."""
    return "\n".join(
        canonicalize_leaders(line.text) for line in lines if line.text
    )


def extract_text_ordered(blocks: list[TextBlock]) -> str:
    """Reference extract_text_ordered (ocr_postprocessor.py:233-243)."""
    return to_markdown(order_blocks(blocks))
