"""Rule/template-based structured field extraction (port of
ocr_system_tpu/extract/rules.py).

The first tier of the local replacement for the reference's Gemini call
(gemini_service.py:235-364): deterministic key-value extraction from the OCR
line stream. SURVEY.md §7.1 step 5 defines this tier explicitly — it also
serves as the guaranteed-quality floor under the layout model.

Heuristics:
  - "Key: Value" / "Key - Value" / "Key = Value" separators on a line
  - label-only lines followed by a value line ("Name" / "John Smith")
  - field-type inference from key hints + value shape (the same regexes the
    validation service accepts, so extracted fields validate cleanly)
  - form-type keywords (Invoice / Application / Medical ...) and language
    detection by script, mirroring the LLM prompt's outputs
    (gemini_service.py:67-71 form_type/language)
  - confidence = OCR line confidence shaded by rule strength (the reference's
    confidence rubric, gemini_service.py:110-120, maps LLM self-assessment;
    here the shading is deterministic)
"""

from __future__ import annotations

import re
import time

from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.service import validation as V

_SEPARATORS = re.compile(r"\s*[:=]\s+|\s+[-–]\s+|\s*[:=]\s*$")

_KEY_TYPE_HINTS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"\be-?mail\b", re.I), "email"),
    (re.compile(r"\b(phone|tel(ephone)?|mobile|cell|fax)\b", re.I), "phone"),
    (re.compile(r"\b(date|dob|birth|issued|expir)\b", re.I), "date"),
    (re.compile(r"\b(amount|total|price|cost|fee|balance|salary|subtotal|tax)\b", re.I), "currency"),
    (re.compile(r"\b(name|applicant|patient|customer|employee)\b", re.I), "name"),
    (re.compile(r"\b(address|street|city|state|zip|pincode)\b", re.I), "address"),
    (re.compile(r"\b(signature|signed)\b", re.I), "signature"),
    (re.compile(r"\b(number|qty|quantity|count|#|no\.)\b", re.I), "number"),
]

_FORM_TYPE_KEYWORDS: list[tuple[re.Pattern, str]] = [
    (re.compile(r"\binvoice\b", re.I), "Invoice"),
    (re.compile(r"\breceipt\b", re.I), "Receipt"),
    (re.compile(r"\b(application|apply)\b", re.I), "Application Form"),
    (re.compile(r"\b(medical|patient|clinic|hospital|prescription)\b", re.I), "Medical Form"),
    (re.compile(r"\b(survey|questionnaire|feedback)\b", re.I), "Survey"),
    (re.compile(r"\b(purchase\s+order|p\.?o\.?\s+number)\b", re.I), "Purchase Order"),
    (re.compile(r"\b(tax|vat|gst)\b", re.I), "Tax Form"),
    (re.compile(r"\bcontract|agreement\b", re.I), "Contract"),
]

_DEVANAGARI_RE = re.compile(r"[ऀ-ॿ]")


def infer_field_type(key: str, value: str) -> str:
    """Key-hint first, then value-shape (validation regexes keep the two
    subsystems agreeing on what 'looks like' each type)."""
    for pat, ftype in _KEY_TYPE_HINTS:
        if pat.search(key):
            return ftype
    v = value.strip()
    if not v:
        return "text"
    if V.EMAIL_RE.match(v.lower()):
        return "email"
    if any(p.match(v) for p in V.PHONE_RES[:2]):
        return "phone"
    if V.DATE_LIKE_RE.search(v) or _parses_as_date(v):
        return "date"
    if V.CURRENCY_RE.match(v) and any(c in v for c in "$£€₹¥"):
        return "currency"
    if V.NUMBER_RE.match(v.replace(" ", "")):
        return "number"
    if v.strip().lower() in V.CHECKBOX_VALUES and v.strip():
        return "checkbox"
    return "text"


def _parses_as_date(v: str) -> bool:
    from datetime import datetime

    for fmt in V.DATE_FORMATS:
        try:
            datetime.strptime(v.strip(), fmt)
            return True
        except ValueError:
            continue
    return False


def infer_form_type(text: str) -> str:
    scores: dict[str, int] = {}
    for pat, name in _FORM_TYPE_KEYWORDS:
        hits = len(pat.findall(text))
        if hits:
            scores[name] = scores.get(name, 0) + hits
    if not scores:
        return "Unknown"
    return max(scores.items(), key=lambda kv: kv[1])[0]


def infer_language(text: str) -> str:
    if not text:
        return "en"
    dev = len(_DEVANAGARI_RE.findall(text))
    if dev > max(len(text) * 0.1, 3):
        return "hi"
    return "en"


_LABEL_RE = re.compile(r"^[A-Za-zऀ-ॿ][\w\s\./#&()ऀ-ॿ'-]{0,60}$")


def _looks_like_label(text: str) -> bool:
    t = text.strip()
    if not t or len(t) > 60:
        return False
    if not _LABEL_RE.match(t):
        return False
    words = t.split()
    return 1 <= len(words) <= 6 and not V.NUMBER_RE.match(t)


class RuleExtractor:
    """Deterministic key-value extractor over reading-ordered OCR lines."""

    name = "rules"

    def extract(
        self,
        ocr_text: str,
        line_confidences: dict[str, float] | None = None,
        template: dict | None = None,
        custom_prompt: str | None = None,  # accepted for interface parity
    ) -> ExtractionResult:
        t0 = time.perf_counter()
        line_confidences = line_confidences or {}
        lines = [ln.strip() for ln in ocr_text.splitlines()]
        lines = [ln for ln in lines if ln and not ln.startswith("## Page")]

        fields: list[ExtractedField] = []
        seen_keys: set[str] = set()
        i = 0
        while i < len(lines):
            line = lines[i]
            conf = line_confidences.get(line, 0.85)
            parts = _SEPARATORS.split(line, maxsplit=1)
            if len(parts) == 2 and _looks_like_label(parts[0]):
                key, value = parts[0].strip(), parts[1].strip()
                if not value and i + 1 < len(lines):
                    # "Key:" with value on next line
                    nxt = lines[i + 1]
                    if not _SEPARATORS.search(nxt):
                        value = nxt.strip()
                        conf = min(conf, line_confidences.get(nxt, 0.85)) * 0.95
                        i += 1
                if key.lower() not in seen_keys:
                    fields.append(
                        ExtractedField(
                            field_key=key,
                            field_value=value,
                            field_type=infer_field_type(key, value),
                            confidence=round(conf, 4),
                        )
                    )
                    seen_keys.add(key.lower())
            i += 1

        if template:
            fields = self._apply_template(fields, lines, line_confidences, template)

        elapsed = int((time.perf_counter() - t0) * 1000)
        return ExtractionResult(
            fields=fields,
            form_type=infer_form_type(ocr_text),
            language=infer_language(ocr_text),
            raw_response=None,
            processing_time_ms=elapsed,
            success=True,
        )

    def _apply_template(
        self,
        fields: list[ExtractedField],
        lines: list[str],
        line_confidences: dict[str, float],
        template: dict,
    ) -> list[ExtractedField]:
        """Bias extraction toward a FormTemplate's expected_fields
        (reference FormTemplate.expected_fields, models.py:634-718): fuzzy-
        rename close keys and add missing expected fields as empty entries
        flagged low-confidence so the review flow surfaces them."""
        from difflib import SequenceMatcher

        expected = template.get("expected_fields") or []
        by_key = {f.field_key.lower(): f for f in fields}
        out = list(fields)
        for exp in expected:
            exp_name = exp if isinstance(exp, str) else exp.get("name", "")
            exp_type = "text" if isinstance(exp, str) else exp.get("field_type", "text")
            if not exp_name:
                continue
            if exp_name.lower() in by_key:
                continue
            best, best_score = None, 0.0
            for f in fields:
                score = SequenceMatcher(
                    None, exp_name.lower(), f.field_key.lower()
                ).ratio()
                if score > best_score:
                    best, best_score = f, score
            if best is not None and best_score >= 0.8:
                best.field_key = exp_name  # canonical template name
                if exp_type != "text":
                    best.field_type = exp_type
            else:
                out.append(
                    ExtractedField(
                        field_key=exp_name,
                        field_value="",
                        field_type=exp_type,
                        confidence=0.0,
                    )
                )
        return out
