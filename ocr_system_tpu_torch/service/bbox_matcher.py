"""Bounding-box matcher: link extracted field text back to OCR polygons
(port of ocr_system_tpu/service/bbox_matcher.py).

Behavior parity with the reference matcher (backend/utils/bbox_matcher.py:25-290),
three strategies in order:
  1. exact normalized line match            -> confidence 1.0      (:77-115)
  2. fuzzy line match (ratio >= 0.85), with containment boost to
     >= 0.9 when one string contains the other                     (:117-153)
  3. multi-word union: each query word fuzzy-matched (>= 0.9)
     against word boxes, require >= 50% of words, axis-aligned
     union polygon, confidence = match ratio capped at 0.95        (:155-238)

Match dict shape: {"polygon": [8 floats], "matched_text": str,
"confidence": float, "page": int} (:240-290).
"""

from __future__ import annotations

import re
from difflib import SequenceMatcher


def normalize(text: str) -> str:
    """Lowercase, collapse whitespace, strip punctuation at the edges
    (reference normalize, bbox_matcher.py:52-63)."""
    text = re.sub(r"\s+", " ", text.strip().lower())
    return text.strip(".,:;!?*#|-_()[]{}\"'")


def fuzzy_ratio(a: str, b: str) -> float:
    return SequenceMatcher(None, a, b).ratio()


def _union_polygon(polys: list[list[float]]) -> list[float]:
    """Axis-aligned union of flat 8-value polygons (reference _compute_union,
    bbox_matcher.py:240-268)."""
    xs = [p[i] for p in polys for i in range(0, 8, 2)]
    ys = [p[i] for p in polys for i in range(1, 8, 2)]
    x0, x1, y0, y1 = min(xs), max(xs), min(ys), max(ys)
    return [x0, y0, x1, y0, x1, y1, x0, y1]


class BoundingBoxMatcher:
    def __init__(
        self,
        line_threshold: float = 0.85,
        containment_boost: float = 0.9,
        word_threshold: float = 0.9,
        min_word_fraction: float = 0.5,
        union_confidence_cap: float = 0.95,
    ):
        self.line_threshold = line_threshold
        self.containment_boost = containment_boost
        self.word_threshold = word_threshold
        self.min_word_fraction = min_word_fraction
        self.union_confidence_cap = union_confidence_cap

    def find_match(self, text: str, layout_boxes: list[dict]) -> dict | None:
        """Find the polygon best matching `text` among layout boxes
        (word + line entries, the engine's Azure-shape dicts)."""
        query = normalize(text)
        if not query:
            return None
        lines = [b for b in layout_boxes if b.get("type") == "line"]
        words = [b for b in layout_boxes if b.get("type") == "word"]

        # 1. exact line match
        for b in lines:
            if normalize(b.get("content", "")) == query:
                return self._hit(b, 1.0)

        # 2. fuzzy line match with containment boost
        best, best_score = None, 0.0
        for b in lines:
            content = normalize(b.get("content", ""))
            if not content:
                continue
            score = fuzzy_ratio(query, content)
            if (query in content or content in query) and len(query) >= 3:
                score = max(score, self.containment_boost)
            if score > best_score:
                best, best_score = b, score
        if best is not None and best_score >= self.line_threshold:
            return self._hit(best, best_score)

        # 3. multi-word union over word boxes
        return self._find_word_union(query, words)

    def _find_word_union(self, query: str, word_boxes: list[dict]) -> dict | None:
        """Reference _find_word_union (bbox_matcher.py:155-208)."""
        query_words = query.split()
        if not query_words:
            return None
        matched: list[dict] = []
        for qw in query_words:
            hit = self._find_single_word(qw, word_boxes, exclude=matched)
            if hit is not None:
                matched.append(hit)
        ratio = len(matched) / len(query_words)
        if not matched or ratio < self.min_word_fraction:
            return None
        polys = [m["polygon"] for m in matched]
        return {
            "polygon": _union_polygon(polys),
            "matched_text": " ".join(m.get("content", "") for m in matched),
            "confidence": min(ratio, self.union_confidence_cap),
            "page": matched[0].get("page_number", 1),
        }

    def _find_single_word(
        self, word: str, word_boxes: list[dict], exclude: list[dict]
    ) -> dict | None:
        """Best word box with ratio >= word_threshold
        (reference _find_single_word, bbox_matcher.py:210-238)."""
        best, best_score = None, 0.0
        for b in word_boxes:
            if b in exclude:
                continue
            content = normalize(b.get("content", ""))
            if not content:
                continue
            score = fuzzy_ratio(word, content)
            if score > best_score:
                best, best_score = b, score
        if best is not None and best_score >= self.word_threshold:
            return best
        return None

    def find_key_value_pair(
        self, key: str, value: str, layout_boxes: list[dict]
    ) -> tuple[dict | None, dict | None]:
        """Match both sides of a field (reference find_key_value_pair,
        bbox_matcher.py:270-290)."""
        return self.find_match(key, layout_boxes), self.find_match(value, layout_boxes)

    @staticmethod
    def _hit(box: dict, confidence: float) -> dict:
        return {
            "polygon": list(box.get("polygon", [])),
            "matched_text": box.get("content", ""),
            "confidence": round(float(confidence), 4),
            "page": box.get("page_number", 1),
        }
