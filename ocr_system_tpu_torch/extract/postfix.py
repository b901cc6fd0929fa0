"""Typed post-correction of extracted values and keys (port of
ocr_system_tpu/extract/postfix.py).

The reference pipeline repairs OCR noise in TWO places: Gemini itself
normalizes values it re-types (gemini_service.py's structured JSON pass),
and validation_service suggests corrections (email space-strip, ISO date
rewrite). The local analog applies the SAFE, type-gated subset at field
emission so serving, eval, and the box-fed path all inherit it:

- digit-context confusion repair: inside digit-dominant values of numeric
  types, OCR letter/digit confusions (O->0, l->1, S->5, B->8, Z->2) flip
  only when a neighbor is a digit — 'carios' in a name stays put, '915O7'
  in a phone becomes 91507. Measured on diag_extract_pipeline: VAL_NOISE
  is dominated by exactly these single-char flips.
- email space removal: emails never contain spaces; rec occasionally
  splits 'acme. com' at a crop boundary.
- key snapping: when the form type is a KNOWN family, extracted keys snap
  to the family's canonical field lexicon on near match (CER <= 0.25,
  unique winner) — the local analog of sending template.expected_fields to
  Gemini (reference extraction_service.py template prompt). Unknown forms
  (random/Devanagari keys) have no lexicon and are left untouched.
"""

from __future__ import annotations

import re

_DIGIT_CONF = {
    "O": "0", "o": "0", "l": "1", "I": "1", "|": "1",
    "S": "5", "B": "8", "Z": "2",
}
_NUMERIC_TYPES = {"phone", "number", "date", "currency"}
_SEP = set(" -+()./,:")

# Letter-context repairs (the reverse direction of _DIGIT_CONF): a digit
# wedged between letters is an OCR misread of a letter, not a digit.
# Measured classes on diag_extract_pipeline (seeds 5251/6260): '0rigin',
# 'Fairview, 0H', 'AIice', 'siIva@', 'lndex', 'ImPortant SupPort'.
_CONSONANTS = set("bcdfghjkmnpqrstvwxz")
_TOKEN_RE = re.compile(r"[A-Za-z0-9]+")


def _repair_token(tok: str, lower_zero: bool) -> str:
    if not any(c.isalpha() for c in tok):
        return tok
    # word-initial 'l' + consonant on an otherwise-alphabetic token is an
    # uppercase I ('lndex' -> 'Index'; len>=4 keeps '5 lbs' intact)
    if (len(tok) >= 4 and tok[0] == "l" and tok[1:].isalpha()
            and tok[1] in _CONSONANTS):
        tok = "I" + tok[1:]
    chars = list(tok)
    for i, c in enumerate(chars):
        prev = chars[i - 1] if i > 0 else ""
        nxt = chars[i + 1] if i + 1 < len(chars) else ""
        if c == "0":
            if prev.isalpha() and nxt.isalpha():
                chars[i] = "o"
            elif not prev and nxt.isalpha():
                # word-initial: 'OH'/'OR' state codes; keys are matched
                # case-insensitively so lower_zero picks 'o' there
                if nxt.isupper():
                    chars[i] = "O"
                elif lower_zero:
                    chars[i] = "o"
        elif c == "1":
            if prev.isalpha() and nxt.isalpha() and (
                    prev.islower() or nxt.islower()):
                chars[i] = "l"
        elif c == "I":
            if prev.isalpha() and nxt.islower():
                chars[i] = "l"
        elif c.isupper() and lower_zero:
            # stray mid-word capital between lowercase letters
            # ('SupPort' -> 'Support'). KEY mode only (lower_zero): keys
            # snap case-insensitively so lowering is free there, while
            # values carry open-vocabulary proper nouns ('BlueKeel
            # Lines') that this rule would destroy.
            if prev.islower() and nxt.islower():
                head = "".join(chars[:i])
                if not (head.endswith("Mc") or head.endswith("Mac")):
                    chars[i] = c.lower()
    return "".join(chars)


def repair_alpha(text: str, lower_zero: bool = False) -> str:
    """Letter-context OCR repair on every alphanumeric token of ``text``.

    Fixes only characters whose in-token neighbors prove the reading wrong
    (digit between letters, mid-word capital I before lowercase, stray
    mid-word capitals). Pure-digit tokens are never touched."""
    if not text:
        return text
    return _TOKEN_RE.sub(lambda m: _repair_token(m.group(0), lower_zero),
                         text)


# US state codes: real-world product knowledge (same standing as the month
# names in validation_service date parsing). Used to resolve the ambiguous
# lowercase-'l' in a 2-letter code before a zip: 'Ml' could be MI (I
# misread as l) or ML (case misread) — only one is a real state.
_STATE_CODES = {
    "AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI",
    "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI",
    "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ", "NM", "NY", "NC",
    "ND", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX", "UT",
    "VT", "VA", "WA", "WV", "WI", "WY", "DC",
}
_STATE_ZIP_RE = re.compile(r"\b([A-Z])([li1I])(?=\s+\d{5}\b)")
_SPLIT_ZIP_RE = re.compile(r"\b([A-Z]{2})\s+(\d{1,4})\s+(\d{1,4})\s*$")


def _repair_address(value: str) -> str:
    """State-code + zip repairs, anchored on the 'XX 12345' tail every US
    address carries: a confusable second letter resolves against the real
    state-code set ('Ml 63629' -> MI, 'Al 35758' -> AL), and a zip the rec
    split mid-run rejoins when the halves make exactly 5 digits
    ('WA 5971 3' -> 'WA 59713')."""

    def _state(m: re.Match) -> str:
        cands = {f"{m.group(1)}{c}" for c in ("I", "L")}
        hits = sorted(cands & _STATE_CODES)
        return hits[0] if len(hits) == 1 else m.group(0)

    value = _STATE_ZIP_RE.sub(_state, value)
    m = _SPLIT_ZIP_RE.search(value)
    if m and len(m.group(2)) + len(m.group(3)) == 5:
        value = (value[: m.start()]
                 + f"{m.group(1)} {m.group(2)}{m.group(3)}")
    return value


def _repair_email(value: str) -> str:
    """Emails never contain spaces; domain separators are dots. Repairs
    ':'/';'/',' in the domain, a dot misread as 'i' directly before a
    known TLD when the domain lost its only dot, and an '@' misread as
    'q' when the value has NO '@' at all (a broken email either way —
    only a unique 'q' yielding user@domain.tld shape is rewritten)."""
    value = value.replace(" ", "")
    if "@" not in value and value.count("q") == 1:
        cand = value.replace("q", "@")
        if re.fullmatch(r"[\w.+-]+@[\w-]+(\.[\w-]+)*\.[a-z]{2,4}", cand):
            value = cand
    user, _, dom = value.partition("@")
    if not dom:
        return value
    dom = re.sub(r"[:;,]", ".", dom)
    if "." not in dom:
        m = re.match(r"^(.*\w)[il](com|org|net)$", dom)
        if m:
            dom = f"{m.group(1)}.{m.group(2)}"
    return f"{user}@{dom}"


_EMAIL_SHAPE_RE = re.compile(r"[\w.+-]+@[\w-]+(\.[\w-]+)*\.[a-z]{2,4}")


def _repair_email_value(value: str) -> str:
    repaired = _repair_email(value)
    user, at, dom = repaired.partition("@")
    if at:
        # email local parts are case-sensitive: no stray-capital lowering
        # there ('JohnDoe@' stays); domains are case-insensitive
        return repair_alpha(user) + "@" + repair_alpha(dom, lower_zero=True)
    return repair_alpha(repaired)


def autocorrect_value(value: str, field_type: str) -> str:
    """Safe, type-gated OCR repair of a field value (see module doc)."""
    if not value:
        return value
    if field_type == "email":
        return _repair_email_value(value)
    if "@" in value and "." in value:
        # untyped '@'-bearing value: commit the space-stripping email
        # rewrite only when the result is actually email-shaped —
        # 'meet @ the cafe. thanks' is prose, not a mangled address
        cand = _repair_email_value(value)
        if _EMAIL_SHAPE_RE.fullmatch(cand):
            return cand
        return repair_alpha(_repair_address(value))
    if field_type == "phone":
        value = value.replace(",", "")  # phone numbers never carry commas
    elif field_type == "number":
        value = value.replace(".-", "-")  # 'INV.-2020' ID-prefix artifact
    if field_type not in _NUMERIC_TYPES:
        return repair_alpha(_repair_address(value))
    digits = sum(c.isdigit() for c in value)
    if digits < 2 or digits < 0.4 * sum(c not in _SEP for c in value):
        # not digit-dominant: 'EUR', 'N/A', prose values
        return repair_alpha(_repair_address(value))
    chars = list(value)
    for i, c in enumerate(chars):
        if c not in _DIGIT_CONF:
            continue
        # an immediate ALPHA neighbor (other than a fellow confusable)
        # means the char sits inside a word — 'Jul 27' must not become
        # 'Ju1 27' just because a digit follows across the space
        imm_p = chars[i - 1] if i > 0 else ""
        imm_n = chars[i + 1] if i + 1 < len(chars) else ""
        if any(x.isalpha() and x not in _DIGIT_CONF for x in (imm_p, imm_n)):
            continue
        prev = next((x for x in reversed(chars[:i]) if x != " "), "")
        nxt = next((x for x in chars[i + 1:] if x != " "), "")
        if prev.isdigit() or nxt.isdigit():
            chars[i] = _DIGIT_CONF[c]
    return repair_alpha("".join(chars))


def _cer(a: str, b: str) -> float:
    """Plain Levenshtein / len(a); local to avoid an eval import cycle."""
    if a == b:
        return 0.0
    if not a or not b:
        return 1.0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1] / len(a)


def clean_key(key: str) -> str:
    """Strip presentation artifacts from an extracted key: trailing ':'
    and dot-leader runs ('Signature..........' labels a signature line;
    the dots are the ruled line, not the key). Keys are alphabetic labels
    matched case-insensitively, so letter-context repair runs with
    lower_zero ('0rigin' -> 'origin')."""
    cleaned = re.sub(r"[.\s]*\.{2,}[.\s]*$", "", key.rstrip(":").strip())
    return repair_alpha(cleaned.strip(), lower_zero=True)


def infer_family_from_keys(
    keys: list[str], predicted: str = "Unknown", min_votes: int = 2
) -> str:
    """Key-evidence form-family vote: when the extracted keys strongly
    match ONE family's lexicon, that family wins over the model head's
    prediction (the local analog of Gemini inferring the template from
    the field labels it reads — ref extraction_service.py template-free
    path). Random keys on true-Unknown forms sit nowhere near any
    lexicon (CER > 0.25 to every entry), so they never vote. A key only
    votes when it matches exactly ONE family — generic labels ('Date',
    'Signature') appear in several lexicons and prove nothing — and
    overriding needs >= ``min_votes`` such keys plus a strict win over
    the predicted family's own vote."""
    counts: dict[str, int] = {f: 0 for f in FORM_KEY_LEXICON}
    for key in keys:
        if not key:
            continue
        k = " ".join(key.lower().split())
        fams = [
            fam for fam, lex in FORM_KEY_LEXICON.items()
            if min(_cer(" ".join(c.lower().split()), k) for c in lex) <= 0.25
        ]
        if len(fams) == 1:
            counts[fams[0]] += 1
    best = max(counts, key=lambda f: counts[f], default=predicted)
    if (counts.get(best, 0) >= min_votes
            and counts[best] > counts.get(predicted, 0)):
        return best
    return predicted


def snap_key(key: str, lexicon: list[str], max_cer: float = 0.25) -> str:
    """Snap a noisy key to its unique near match in a canonical lexicon.

    'monthily fee' -> 'Monthly Fee' when the form family is known. Returns
    the ORIGINAL key when no lexicon entry is near, when two are equally
    near (ambiguous), or when the key already matches exactly."""
    if not key or not lexicon:
        return key
    kl = " ".join(key.lower().split())
    best: tuple[float, str] | None = None
    second = 2.0
    for cand in lexicon:
        c = _cer(" ".join(cand.lower().split()), kl)
        if best is None or c < best[0]:
            second = best[0] if best else 2.0
            best = (c, cand)
        elif c < second:
            second = c
    if best is None or best[0] > max_cer:
        return key
    if best[0] > 0.0 and second <= max_cer:
        return key  # two near candidates: ambiguous, keep OCR reading
    return best[1] if best[0] > 0.0 else key


# canonical field lexicons per KNOWN form family — product knowledge, the
# same role as FormTemplate.expected_fields (db seed templates carry these
# too). Kept in extract/ so the extractor has no training-module import.
FORM_KEY_LEXICON: dict[str, list[str]] = {
    "Invoice": [
        "Invoice Number", "Invoice Date", "Due Date", "Vendor", "Customer",
        "Subtotal", "Tax", "Total Amount", "Payment Method", "Email",
        "Phone", "Billing Address",
    ],
    "Receipt": [
        "Receipt Number", "Date", "Cashier", "Amount Paid", "Change",
        "Payment Method", "Store Phone",
    ],
    "Application Form": [
        "Full Name", "Date of Birth", "Email", "Phone Number", "Address",
        "Position", "Signature", "Date", "Referred By",
    ],
    "Medical Form": [
        "Patient Name", "Date of Birth", "Insurance ID", "Physician",
        "Allergies", "Blood Type", "Emergency Contact", "Visit Date",
    ],
    "Survey": [
        "Respondent", "Date", "Satisfied", "Would Recommend", "Comments",
        "Contact Email",
    ],
    "Purchase Order": [
        "PO Number", "Order Date", "Supplier", "Ship To", "Total",
        "Approved By", "Delivery Date",
    ],
    "Tax Form": [
        "Tax Year", "Taxpayer Name", "Filing Status", "Gross Income",
        "Deductions", "Tax Due", "Signature",
    ],
    "Contract": [
        "Party A", "Party B", "Effective Date", "Term", "Monthly Fee",
        "Signature", "Witness",
    ],
}
