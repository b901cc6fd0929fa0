"""Multi-turn extraction chat (reference: gemini_service.py:584-604
`create_extraction_chat` — a Gemini chat session "for clarifying ambiguous
extractions / follow-up questions"; the reference never wires it to a
route).

Port of ``ocr_system_tpu/extract/chat.py``: the same code, on the port's modules.

The local analog is a deterministic, grounded conversational agent over one
extraction's artifacts: its fields (key/value/confidence/validation/bbox),
its OCR text, and the page layout boxes. Answers are COMPOSED (attribute
phrasing, citations, recommendations) but always quote the extraction — so
they cannot hallucinate values. The API exposes it at
`POST /api/extractions/{id}/chat` (beyond the reference, which kept the
chat service-internal).

Conversation state: each assistant turn records which fields it referenced;
follow-ups ("and its confidence?", "what page is that on?") resolve
pronouns against that focus. The server is stateless — clients round-trip
`history` (incl. per-turn field refs) exactly as the route returns it.

Understood intents:
  - field lookup:    "what is the invoice number?", "total amount?"
  - attribute F/U:   "and its confidence?", "what page is it on?",
                     "where is it?", "is it valid?", "was it edited?"
  - field listing:   "what fields did you find", "list fields on page 2"
  - low confidence:  "which fields are uncertain (on page N) (below 80%)"
  - aggregation:     "how many fields", "average confidence"
  - reconciliation:  "reconcile the dates", "which value is right?"
  - layout re-query: asked key absent from the extraction -> search the
                     page layout for the label and its geometric neighbor
                     (the same nearest-box pairing the extractor uses)
  - text search:     "find <text>" or any other message — OCR line search
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


def _norm(s: str) -> str:
    return " ".join(re.sub(r"[^a-z0-9 ]", " ", s.lower()).split())


def _tokens(s: str) -> set[str]:
    return set(_norm(s).split())


def _sing(tokens: set[str]) -> set[str]:
    """Plural-insensitive comparison set ('dates' asks about 'Date')."""
    return {t[:-1] if len(t) > 3 and t.endswith("s") else t for t in tokens}


_STOP = _tokens(
    "what is the a an of for my this that are was please tell me show give"
    " whats value did you find extract extracted it and about on in"
)

_LIST_RE = re.compile(
    r"\b(list|show|enumerate)\b.*\bfields?\b|\bwhat\b.*\b(fields?|found|extract)",
    re.I,
)
_UNCERTAIN_RE = re.compile(
    r"\b(uncertain|unsure|low.confiden|review|doubt|confident)", re.I
)
_FIND_RE = re.compile(r"\b(?:find|search|where(?:'s| is)?|locate)\b\s*(.*)", re.I)
_COUNT_RE = re.compile(r"\bhow many\b|\bcount\b.*\bfields?\b", re.I)
_AVG_RE = re.compile(r"\b(average|mean|overall)\b.*\bconfiden", re.I)
_RECONCILE_RE = re.compile(
    r"\b(reconcile|conflict|disagree|duplicate|which (?:one |value |date )?is"
    r" (?:right|correct))\b", re.I,
)
_PAGE_RE = re.compile(r"\bpage\s+(\d+)\b", re.I)
_BELOW_RE = re.compile(r"\b(?:below|under|less than)\s+(\d+)\s*%", re.I)
# pronoun-ish references that resolve against the conversation focus
_FOLLOWUP_RE = re.compile(
    r"\b(it|its|that|this|the field|that field|one)\b", re.I
)
# attribute of a field the user can ask about
_ATTR_RES = {
    "confidence": re.compile(r"\bconfiden|\bsure\b|\bcertain\b", re.I),
    "page": re.compile(r"\b(?:what|which)\s+page\b|\bpage\b\s*\?", re.I),
    "location": re.compile(r"\bwhere\b|\blocat|\bposition\b|\bbbox\b", re.I),
    "valid": re.compile(r"\bvalid|\bpass(?:ed)?\b.*\bvalidation", re.I),
    "original": re.compile(r"\boriginal\b|\bedited\b|\bbefore\b.*\bedit", re.I),
    "type": re.compile(r"\b(?:what|which)\s+type\b|\bfield type\b", re.I),
}


def _conf_pct(f: dict) -> int:
    return round(float(f.get("confidence", 0) or 0) * 100)


def _conf_word(f: dict) -> str:
    c = float(f.get("confidence", 0) or 0)
    return "high" if c >= 0.9 else "medium" if c >= 0.6 else "low"


def _field_page(f: dict) -> int | None:
    for bb in (f.get("value_bbox"), f.get("key_bbox")):
        if isinstance(bb, dict) and bb.get("page"):
            return int(bb["page"])
    p = f.get("page_number")
    return int(p) if p else None


def _cite(f: dict) -> str:
    """'(page 2, near (140, 96))' — bbox-grounded citation when known."""
    page = _field_page(f)
    poly = None
    for bb in (f.get("value_bbox"), f.get("key_bbox")):
        if isinstance(bb, dict) and bb.get("polygon"):
            poly = bb["polygon"]
            break
    if page is None and poly is None:
        return ""
    parts = []
    if page is not None:
        parts.append(f"page {page}")
    if poly and len(poly) >= 2:
        parts.append(f"near ({round(poly[0])}, {round(poly[1])})")
    return " (" + ", ".join(parts) + ")"


@dataclass
class ChatTurn:
    role: str  # "user" | "assistant"
    text: str
    fields: list[str] = field(default_factory=list)  # referenced field keys


@dataclass
class ExtractionChat:
    """Stateful multi-turn session over one extraction."""

    fields: list[dict]  # {field_key, field_value, confidence, field_type, ...}
    ocr_text: str = ""
    layout_boxes: list[dict] = field(default_factory=list)
    history: list[ChatTurn] = field(default_factory=list)

    def send(self, message: str) -> dict:
        """-> {"reply": str, "matched_fields": [field_key, ...]}"""
        self.history.append(ChatTurn("user", message))
        reply, matched = self._answer(message.strip())
        self.history.append(ChatTurn("assistant", reply, list(matched)))
        return {"reply": reply, "matched_fields": matched}

    # ---- conversation focus ----

    def _focus(self) -> dict | None:
        """The field the conversation is 'about': the most recent assistant
        turn that referenced exactly one field wins; a multi-field turn
        (listing) doesn't narrow focus."""
        for turn in reversed(self.history[:-1]):  # skip current user turn
            if turn.role == "assistant" and len(turn.fields) == 1:
                return self._by_key(turn.fields[0])
        return None

    def _by_key(self, key: str) -> dict | None:
        for f in self.fields:
            if f["field_key"] == key:
                return f
        return None

    # ---- intent dispatch ----

    def _answer(self, message: str) -> tuple[str, list[str]]:
        if not message:
            return (
                "Ask about a field, 'list fields', 'which are uncertain', "
                "or 'where is <field>'.", [],
            )
        if _RECONCILE_RE.search(message):
            return self._reconcile(message)
        if _AVG_RE.search(message):
            return self._average_confidence()
        if _COUNT_RE.search(message):
            return self._count_fields(message)
        if _LIST_RE.search(message):
            return self._list_fields(message)
        if (
            _UNCERTAIN_RE.search(message)
            or (_BELOW_RE.search(message) and re.search(r"\bfields?\b", message, re.I))
        ) and not _FOLLOWUP_RE.search(message):
            return self._uncertain_fields(message)

        # attribute question — about a named field or the focus
        attr = next(
            (a for a, rx in _ATTR_RES.items() if rx.search(message)), None
        )
        if attr:
            target = self._match_field(message)
            if target is None and _FOLLOWUP_RE.search(message):
                target = self._focus()
            if target is not None:
                return self._attribute(target, attr)

        # precedence: exact field > subset-partial ("total?" ⊆ "Total
        # Amount") > layout re-query (key absent from the extraction) >
        # weak partial > OCR text search
        m = _FIND_RE.search(message)
        query = m.group(1) if m and m.group(1).strip() else message
        exact = self._field_lookup(message, allow_partial=False)
        if exact is not None:
            return exact
        q = _tokens(query) - _STOP
        subset = self._match_field(message, min_overlap=0.5)
        if (
            subset is not None
            and q
            and q <= _tokens(subset["field_key"])
        ):
            return self._field_lookup(message)
        requeried = self._requery_layout(query)
        if requeried is not None:
            return requeried
        partial = self._field_lookup(message)
        if partial is not None:
            return partial
        return self._search_text(query)

    # ---- field matching ----

    def _match_field(self, message: str, min_overlap: float = 0.99):
        q = _tokens(message) - _STOP
        if not q:
            return None
        best, best_score = None, 0.0
        for f in self.fields:
            kt = _tokens(f["field_key"])
            if not kt:
                continue
            overlap = len(q & kt) / len(kt)
            if overlap > best_score:
                best, best_score = f, overlap
        return best if best_score >= min_overlap else None

    # ---- intent handlers ----

    def _attribute(self, f: dict, attr: str) -> tuple[str, list[str]]:
        k, key = f["field_key"], [f["field_key"]]
        if attr == "confidence":
            return (
                f"{k} is {_conf_pct(f)}% confident ({_conf_word(f)}).", key
            )
        if attr == "page":
            p = _field_page(f)
            return (
                f"{k} is on page {p}." if p else
                f"No page recorded for {k}.", key,
            )
        if attr == "location":
            cite = _cite(f)
            return (
                f"{k} = {f['field_value']!r}{cite}." if cite else
                f"{k} has no recorded location on the page.", key,
            )
        if attr == "valid":
            if f.get("is_valid") is False:
                why = f.get("validation_message") or "failed validation"
                return (f"{k} is NOT valid: {why}.", key)
            if f.get("needs_review"):
                return (f"{k} passed validation but is flagged for review "
                        f"({_conf_pct(f)}% confidence).", key)
            if f.get("is_valid"):
                return (f"{k} is valid.", key)
            return (f"{k} has not been validated yet.", key)
        if attr == "original":
            if f.get("is_edited") and f.get("original_value") is not None:
                return (
                    f"{k} was edited: originally {f['original_value']!r}, "
                    f"now {f['field_value']!r}.", key,
                )
            return (f"{k} has not been edited; the extracted value stands: "
                    f"{f['field_value']!r}.", key)
        if attr == "type":
            return (f"{k} is a {f.get('field_type', 'text')} field.", key)
        return (f"{k}: {f['field_value']!r}.", key)

    def _page_subset(self, message: str) -> tuple[list[dict], str]:
        m = _PAGE_RE.search(message)
        if not m:
            return self.fields, ""
        page = int(m.group(1))
        return (
            [f for f in self.fields if _field_page(f) == page],
            f" on page {page}",
        )

    def _list_fields(self, message: str = "") -> tuple[str, list[str]]:
        fields, suffix = self._page_subset(message)
        if not fields:
            return (f"No fields were extracted{suffix}.", [])
        lines = [
            f"- {f['field_key']}: {f['field_value']!r} ({_conf_pct(f)}%)"
            for f in fields
        ]
        return (
            f"{len(fields)} field(s) extracted{suffix}:\n" + "\n".join(lines),
            [f["field_key"] for f in fields],
        )

    def _uncertain_fields(self, message: str = "") -> tuple[str, list[str]]:
        fields, suffix = self._page_subset(message)
        m = _BELOW_RE.search(message)
        thresh = int(m.group(1)) / 100.0 if m else 0.6
        low = [
            f for f in fields
            if float(f.get("confidence", 0.0) or 0.0) < thresh
            or f.get("is_valid") is False
            or f.get("needs_review")
            or f.get("validation_status") in ("invalid", "warning")
        ]
        if not low:
            return (f"All fields{suffix} look confident and valid.", [])
        lines = [
            f"- {f['field_key']}: {f['field_value']!r} ({_conf_pct(f)}%)"
            + (f" — {f['validation_message']}"
               if f.get("is_valid") is False and f.get("validation_message")
               else "")
            for f in low
        ]
        return (
            f"These fields{suffix} deserve review:\n" + "\n".join(lines),
            [f["field_key"] for f in low],
        )

    def _count_fields(self, message: str) -> tuple[str, list[str]]:
        fields, suffix = self._page_subset(message)
        return (f"{len(fields)} field(s){suffix}.", [])

    def _average_confidence(self) -> tuple[str, list[str]]:
        if not self.fields:
            return ("No fields were extracted from this document.", [])
        avg = sum(
            float(f.get("confidence", 0) or 0) for f in self.fields
        ) / len(self.fields)
        lo = min(self.fields, key=lambda f: float(f.get("confidence", 0) or 0))
        return (
            f"Average confidence across {len(self.fields)} fields: "
            f"{round(avg * 100)}%. Lowest: {lo['field_key']} "
            f"({_conf_pct(lo)}%).", [lo["field_key"]],
        )

    def _reconcile(self, message: str) -> tuple[str, list[str]]:
        """Surface conflicting evidence: duplicate keys with different
        values, and edited fields whose current value departs from the OCR.
        Recommends by validation state first, then confidence."""
        q = _sing(_tokens(message) - _STOP - _tokens(
            "reconcile conflict conflicts disagree duplicate which right"
            " correct one is"
        ))
        groups: dict[str, list[dict]] = {}
        for f in self.fields:
            nk = _norm(f["field_key"])
            if q and not (q & _sing(_tokens(nk))):
                continue
            groups.setdefault(nk, []).append(f)
        conflicts = {
            k: fs for k, fs in groups.items()
            if len({_norm(str(f["field_value"])) for f in fs}) > 1
        }
        if conflicts:
            out, keys = [], []
            for _, fs in conflicts.items():
                ranked = sorted(fs, key=lambda f: (
                    f.get("is_valid") is not False,
                    not f.get("needs_review"),
                    float(f.get("confidence", 0) or 0),
                ), reverse=True)
                winner = ranked[0]
                out.append(
                    f"{fs[0]['field_key']} has {len(fs)} conflicting values: "
                    + "; ".join(
                        f"{f['field_value']!r} ({_conf_pct(f)}%"
                        + (", invalid" if f.get("is_valid") is False else "")
                        + ")"
                        for f in ranked
                    )
                    + f". Recommend {winner['field_value']!r}"
                    + _cite(winner) + "."
                )
                keys += [f["field_key"] for f in fs]
            return ("\n".join(out), keys)
        # no duplicate-key conflicts: report edit-vs-OCR divergences
        edited = [
            f for f in self.fields
            if f.get("is_edited")
            and f.get("original_value") not in (None, f.get("field_value"))
            and (not q or (q & _sing(_tokens(f["field_key"]))))
        ]
        if edited:
            lines = [
                f"- {f['field_key']}: extracted {f['original_value']!r}, "
                f"edited to {f['field_value']!r} (the edit stands; the "
                f"original is preserved for audit)"
                for f in edited
            ]
            return ("No duplicate fields conflict, but these were edited "
                    "away from the OCR reading:\n" + "\n".join(lines),
                    [f["field_key"] for f in edited])
        return ("No conflicting fields found — every key has one value.", [])

    def _field_lookup(
        self, message: str, allow_partial: bool = True
    ) -> tuple[str, list[str]] | None:
        best = self._match_field(message, min_overlap=0.99)
        if best is None:
            partial = (
                self._match_field(message, min_overlap=0.5)
                if allow_partial else None
            )
            if partial is not None:
                return (
                    f"Closest field: {partial['field_key']} ="
                    f" {partial['field_value']!r} ({_conf_pct(partial)}%"
                    f" confidence){_cite(partial)}.",
                    [partial["field_key"]],
                )
            return None
        return (
            f"{best['field_key']}: {best['field_value']!r}"
            f" ({_conf_pct(best)}% confidence){_cite(best)}.",
            [best["field_key"]],
        )

    def _requery_layout(self, query: str) -> tuple[str, list[str]] | None:
        """The asked key is NOT an extracted field: re-query the page layout
        the way the extractor pairs labels — find a box whose text matches
        the ask, then take its inline remainder after ':' or its nearest
        right/below neighbor as the candidate value."""
        q = _tokens(query) - _STOP
        if not q or not self.layout_boxes:
            return None
        label, label_score = None, 0.0
        for b in self.layout_boxes:
            content = str(b.get("content", ""))
            bt = _tokens(content)
            if not bt:
                continue
            score = len(q & bt) / max(len(q), 1)
            if score > label_score or (
                score == label_score and score > 0
                and label is not None
                and len(bt) < len(_tokens(str(label.get("content", ""))))
            ):
                label, label_score = b, score
        if label is None or label_score < 0.99:  # every asked token present
            return None
        content = str(label.get("content", ""))
        page = label.get("page_number", 1)
        poly = label.get("polygon") or []
        cite = f" (page {page}" + (
            f", near ({round(poly[0])}, {round(poly[1])})" if len(poly) >= 2
            else ""
        ) + ")"
        # inline 'Label: value' in the same box
        if ":" in content:
            after = content.split(":", 1)[1].strip()
            if after:
                return (
                    f"Not an extracted field, but the page shows "
                    f"{content!r}{cite} — candidate value {after!r}.", [],
                )
        # nearest neighbor to the right / below (extractor-style pairing)
        cand = self._nearest_neighbor(label)
        if cand is not None:
            return (
                f"Not an extracted field, but the page shows {content!r}"
                f"{cite}; the adjacent text reads "
                f"{str(cand.get('content', '')).strip()!r} — candidate "
                f"value.", [],
            )
        return (
            f"The page shows {content!r}{cite}, but nothing adjacent reads "
            f"as its value.", [],
        )

    def _nearest_neighbor(self, label: dict) -> dict | None:
        poly = label.get("polygon") or []
        if len(poly) < 8:
            return None
        lx = max(poly[0::2])
        ly = (min(poly[1::2]) + max(poly[1::2])) / 2.0
        lh = max(poly[1::2]) - min(poly[1::2])
        page = label.get("page_number", 1)
        best, best_d = None, float("inf")
        for b in self.layout_boxes:
            if b is label or b.get("page_number", 1) != page:
                continue
            p = b.get("polygon") or []
            if len(p) < 8 or not str(b.get("content", "")).strip():
                continue
            bx = min(p[0::2])
            by = (min(p[1::2]) + max(p[1::2])) / 2.0
            dx, dy = bx - lx, by - ly
            if dx < -2 * lh or dy < -1.5 * lh:  # only right/below
                continue
            d = abs(dx) + 3.0 * abs(dy)  # same-row preferred
            if d < best_d:
                best, best_d = b, d
        return best if best_d < 40.0 * max(lh, 1.0) else None

    def _search_text(self, query: str) -> tuple[str, list[str]]:
        q = _tokens(query) - _STOP
        if not q:
            return ("Ask about a field, or 'list fields'.", [])
        hits = [
            ln for ln in self.ocr_text.splitlines()
            if ln.strip() and q & _tokens(ln)
        ][:5]
        if not hits:
            return (
                f"No OCR line mentions {' '.join(sorted(q))!r}.", []
            )
        return ("Matching OCR lines:\n" + "\n".join(f"> {h}" for h in hits),
                [])
