"""Lexicon-guided re-segmentation of column-merged detection boxes (port
of ocr_system_tpu/engine/glue_split.py).

On tight multi-column form pages the detector sometimes merges a field
VALUE with the NEXT column's LABEL into one box ('mary novak' +
'Blood Type:' decoding as 'mary novakbiood:type').  Both fields then die
downstream: the value pairs with the wrong label and the label's own value
goes unlabeled.  Two det fine-tunes on this distribution were gated and
rejected (round 4) — the granularity fix has to be structural, not
learned.

The split is text-guided and geometry-verified:

  1. a decoded box's TAIL fuzzy-matches a known form label (the union of
     extract/postfix.FORM_KEY_LEXICON, alphanumeric-normalized) with colon
     evidence near it, and real value text sits in FRONT of the match;
  2. the estimated glyph boundary is snapped to an actual INK GAP in the
     page (column merges always straddle whitespace; prose does not), and
     the split is abandoned when no such gap exists;
  3. both halves are re-recognized at natural scale in one batched
     dispatch per wave (the glued crop was squeezed ~2x, so the halves
     usually decode strictly better).

Reference anchor: the component whose extraction quality this protects is
gemini_service.py:235-364 — an LLM reads labels out of merged lines for
free; a deterministic extractor needs the det geometry fixed instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ocr_system_tpu_torch.extract.postfix import FORM_KEY_LEXICON


def _normalize(text: str) -> tuple[str, list[int]]:
    """Lowercased alphanumeric projection of `text` plus, per normalized
    char, its index in the original string (colon/space/misread-punct
    noise at the value-label boundary must not break the match)."""
    out: list[str] = []
    idx: list[int] = []
    for i, c in enumerate(text):
        if c.isalnum():
            out.append(c.lower())
            idx.append(i)
    return "".join(out), idx


def _edit_distance(a: str, b: str, limit: int) -> int:
    """Banded Levenshtein: returns > limit early when the distance must
    exceed `limit` (keys are short; the band keeps this O(len * limit))."""
    if abs(len(a) - len(b)) > limit:
        return limit + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        lo = limit + 1
        for j, cb in enumerate(b, 1):
            v = min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb))
            cur.append(v)
            lo = min(lo, v)
        if lo > limit:
            return limit + 1
        prev = cur
    return prev[-1]


def _union_lexicon() -> list[tuple[str, str]]:
    """(canonical label, normalized) for every known form key long enough
    to be unambiguous as a tail match (short generics like 'Date', 'Tax'
    or 'Term' appear inside ordinary values too often to trust)."""
    seen: dict[str, str] = {}
    for lex in FORM_KEY_LEXICON.values():
        for key in lex:
            norm = "".join(c.lower() for c in key if c.isalnum())
            if len(norm) >= 5:
                seen.setdefault(norm, key)
    # longest first: 'blood type' must win over a shorter key that also
    # happens to match inside it
    return sorted(
        ((k, n) for n, k in seen.items()), key=lambda kn: -len(kn[1])
    )


_UNION: list[tuple[str, str]] | None = None


@dataclass
class GlueMatch:
    char_start: int  # index in the ORIGINAL text where the label begins
    label: str       # canonical label matched


def find_glued_label(text: str) -> GlueMatch | None:
    """Does `text` look like '<value><known-label>[:]'?  Returns where the
    label starts, or None.  Precision gates:

      - the label match must END within the last 2 normalized chars;
      - >= 3 normalized chars of value must precede it;
      - a ':' must appear inside or just after the matched span (labels
        carry one; its position is unreliable under OCR noise, its
        presence is not);
      - edit budget scales with label length (1 per ~5 chars).
    """
    global _UNION
    if _UNION is None:
        _UNION = _union_lexicon()
    if len(text) < 9 or ":" not in text:
        return None
    norm, idx = _normalize(text)
    n = len(norm)
    if n < 8:
        return None
    # fewest edits wins; ties go to the longer label ('blood type' beats a
    # shorter key matching inside it)
    best: tuple[int, int, int, str] | None = None  # (edits, -len, start, label)
    for label, lnorm in _UNION:
        m = len(lnorm)
        limit = max(1, m // 5)
        for end in (n, n - 1, n - 2):
            for start in range(
                max(3, end - m - limit), end - m + limit + 1
            ):
                if start >= end:
                    continue
                d = _edit_distance(lnorm, norm[start:end], limit)
                if d <= limit:
                    cand = (d, -m, start, label)
                    if best is None or cand < best:
                        best = cand
    if best is None:
        return None
    start_orig = idx[best[2]]
    # colon evidence: a ':' inside or just after the matched label span
    if ":" not in text[max(start_orig - 1, 0):]:
        return None
    return GlueMatch(char_start=start_orig, label=best[3])


def find_ink_gap(
    gray: np.ndarray, quad: np.ndarray, frac: float,
    window: float = 0.22, ink_thresh_rel: float = 0.5,
) -> float | None:
    """Snap an estimated split fraction to the widest whitespace run in
    the box's column-ink profile near it.  Returns the refined fraction
    along the box width, or None when no convincing gap exists (then the
    split is NOT performed — prose has no column gap)."""
    h, w = gray.shape[:2]
    x0 = int(np.clip(quad[:, 0].min(), 0, w - 1))
    x1 = int(np.clip(quad[:, 0].max(), x0 + 1, w))
    y0 = int(np.clip(quad[:, 1].min(), 0, h - 1))
    y1 = int(np.clip(quad[:, 1].max(), y0 + 1, h))
    box_w, box_h = x1 - x0, y1 - y0
    if box_w < 12 or box_h < 4:
        return None
    win = gray[y0:y1, x0:x1]
    lo, hi = float(win.min()), float(win.max())
    if hi - lo < 30:  # blank or solid box: nothing to split
        return None
    thresh = lo + (hi - lo) * ink_thresh_rel
    ink = (win < thresh).sum(axis=0)  # ink pixel count per column
    cx = int(frac * box_w)
    wl = max(int(box_w * window), 4)
    lo_x, hi_x = max(cx - wl, 0), min(cx + wl, box_w)
    blank = ink[lo_x:hi_x] == 0
    if not blank.any():
        return None
    # widest blank run in the window
    edges = np.flatnonzero(np.diff(np.concatenate(([0], blank, [0]))))
    runs = edges.reshape(-1, 2)
    widths = runs[:, 1] - runs[:, 0]
    k = int(widths.argmax())
    # a real inter-column gap is wide relative to glyph spacing
    if widths[k] < max(3, box_h // 3):
        return None
    center = lo_x + (runs[k, 0] + runs[k, 1]) / 2.0
    return float(center / box_w)


def split_quad(quad: np.ndarray, frac: float) -> tuple[np.ndarray, np.ndarray]:
    """Split a quad at `frac` along its reading direction."""
    tl, tr, br, bl = quad
    top = tl + (tr - tl) * frac
    bot = bl + (br - bl) * frac
    left = np.stack([tl, top, bot, bl]).astype(np.float32)
    right = np.stack([top, tr, br, bot]).astype(np.float32)
    return left, right


def plan_splits(
    gray: np.ndarray, boxes, texts: list[str]
) -> list[tuple[int, np.ndarray, np.ndarray, str]]:
    """For one page: (box index, left quad, right quad, canonical label)
    for every det box whose decoded text carries a glued trailing label
    AND whose pixels show a column gap where the label should start."""
    out = []
    for i, (b, text) in enumerate(zip(boxes, texts)):
        if not text or len(text) < 9 or ":" not in text:
            continue
        m = find_glued_label(text)
        if m is None:
            continue
        frac = find_ink_gap(gray, b.quad, m.char_start / max(len(text), 1))
        if frac is None or frac < 0.1 or frac > 0.9:
            continue
        left, right = split_quad(b.quad, frac)
        out.append((i, left, right, m.label))
    return out
