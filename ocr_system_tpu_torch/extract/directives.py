"""Constrained extraction directives: custom_prompt + template -> steering
(port of ocr_system_tpu/extract/directives.py).

The reference injects ``custom_prompt`` and the FormTemplate into the Gemini
prompt, and the LLM actually honors them (gemini_service.py:511-549). A
deterministic extractor cannot honor free text, but it CAN honor a parsed
directive subset — and that subset covers what templates are for:

  - an expected-field list (from the template AND/OR named in the prompt),
  - "extract only the listed fields",
  - per-field type hints ("Invoice Date is a date"),
  - field exclusions ("ignore Comments").

Directives act at two levels in extract/layout_model.LayoutModelExtractor:

  1. DECODE-TIME: chars matching an expected field name get a KEY-tag
     log-prob bonus before element_vote pools sub-word tags — the model's
     own ambiguous reads resolve toward the template (key_tag_bias).
  2. FIELD-LEVEL: keys snap to expected names, type hints override the
     type head (and re-gate value autocorrect), excluded keys drop,
     only_expected filters, and missing expected fields emit as empty
     low-confidence entries for the review flow (apply_directives) —
     behavior-compatible with rules.RuleExtractor._apply_template.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from ocr_system_tpu_torch.extract.postfix import autocorrect_value, snap_key
from ocr_system_tpu_torch.extract.types import ExtractedField
from ocr_system_tpu_torch.models.layout_extractor import TAGS

_I_BK, _I_IK = TAGS.index("B-KEY"), TAGS.index("I-KEY")

_TYPE_WORDS = r"(?:date|phone|email|number|currency|text|address|name)"

# "X is a date", "treat X as a phone", "X: date"
_TYPE_HINT_RE = re.compile(
    rf"(?:treat\s+)?(?P<name>[A-Za-z][\w /&-]{{1,40}}?)\s+"
    rf"(?:is|as)\s+an?\s+(?P<type>{_TYPE_WORDS})\b",
    re.IGNORECASE,
)
# "extract only ...", "only extract ...", "extract the following fields: ..."
_ONLY_RE = re.compile(
    r"\b(?:extract\s+only|only\s+extract|return\s+only)\b", re.IGNORECASE
)
_FIELDS_RE = re.compile(
    r"\b(?:extract|fields?|columns?)\s*(?:only)?\s*[:\-]\s*(?P<list>[^.;\n]+)",
    re.IGNORECASE,
)
_IGNORE_RE = re.compile(
    r"\b(?:ignore|exclude|skip|omit)\s+(?P<list>[^.;\n]+)", re.IGNORECASE
)


@dataclass
class Directives:
    expected: list[tuple[str, str]] = field(default_factory=list)  # (name, type)
    only_expected: bool = False
    exclude: list[str] = field(default_factory=list)

    @property
    def names(self) -> list[str]:
        return [n for n, _ in self.expected]

    def type_of(self, name: str) -> str | None:
        low = name.lower()
        for n, t in self.expected:
            if n.lower() == low and t and t != "text":
                return t
        return None


def _split_names(raw: str) -> list[str]:
    parts = re.split(r",|\band\b|;", raw)
    out = []
    for p in parts:
        p = p.strip().strip("'\"").strip()
        if p and 1 <= len(p.split()) <= 5 and re.search(r"[A-Za-z]", p):
            out.append(p)
    return out


def parse_directives(
    custom_prompt: str | None, template: dict | None
) -> Directives | None:
    """None when neither source carries anything actionable (the common
    serving path pays nothing)."""
    d = Directives()
    if template:
        for exp in template.get("expected_fields") or []:
            if isinstance(exp, str):
                name, typ = exp, "text"
            else:
                name = exp.get("name") or exp.get("field_name") or ""
                typ = exp.get("field_type") or exp.get("type") or "text"
            if name:
                d.expected.append((name, typ))
    if custom_prompt:
        text = custom_prompt.strip()
        if _ONLY_RE.search(text):
            d.only_expected = True
        for m in _FIELDS_RE.finditer(text):
            for name in _split_names(m.group("list")):
                if name.lower() not in (n.lower() for n in d.names):
                    d.expected.append((name, "text"))
        for m in _TYPE_HINT_RE.finditer(text):
            name, typ = m.group("name").strip(), m.group("type").lower()
            low = name.lower()
            replaced = False
            for i, (n, _t) in enumerate(d.expected):
                if n.lower() == low:
                    d.expected[i] = (n, typ)
                    replaced = True
            if not replaced:
                d.expected.append((name, typ))
        for m in _IGNORE_RE.finditer(text):
            d.exclude.extend(_split_names(m.group("list")))
    if not d.expected and not d.exclude:
        return None
    return d


def key_tag_bias(
    tag_logp, tokens_text: str, directives: Directives, bonus: float = 2.5
) -> None:
    """In-place KEY-tag log-prob bonus on char spans matching an expected
    field name (case-insensitive substring of the token stream). Runs
    BEFORE element_vote so sub-word pooling resolves ambiguous reads
    toward the template — the decode-time analog of the template prompt
    biasing Gemini's reading."""
    low = tokens_text.lower()
    for name in directives.names:
        pat = name.lower()
        start = 0
        while True:
            i = low.find(pat, start)
            if i < 0:
                break
            tag_logp[i : i + len(pat), _I_BK] += bonus
            tag_logp[i : i + len(pat), _I_IK] += bonus
            start = i + 1


def apply_directives(fields: list, directives: Directives) -> list:
    """Field-level steering (see module doc). `fields` entries are
    extract.types.ExtractedField; returns a new list."""
    names = directives.names
    excluded = {e.lower() for e in directives.exclude}
    out = []
    for f in fields:
        if f.field_key:
            snapped = snap_key(f.field_key, names, max_cer=0.34)
            if snapped != f.field_key:
                f.field_key = snapped
        if f.field_key.lower() in excluded:
            continue
        hint = directives.type_of(f.field_key) if f.field_key else None
        if hint and hint != f.field_type:
            f.field_type = hint
            f.field_value = autocorrect_value(f.field_value, hint)
        if directives.only_expected and f.field_key.lower() not in (
            n.lower() for n in names
        ):
            continue
        out.append(f)
    present = {f.field_key.lower() for f in out if f.field_key}
    for name, typ in directives.expected:
        if name.lower() in present or name.lower() in excluded:
            continue
        out.append(
            ExtractedField(
                field_key=name, field_value="", field_type=typ,
                confidence=0.0,
            )
        )
    return out
