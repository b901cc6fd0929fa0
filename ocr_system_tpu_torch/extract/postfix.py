"""Form keys for the engine's glue split: the part of
ocr_system_tpu/extract/postfix.py that the engine uses
(``FORM_KEY_LEXICON``, ``_cer``, ``clean_key`` and the letter-context
repair that ``clean_key`` runs). The typed value repairs, key snapping and the
family vote belong to extraction and come with it."""

from __future__ import annotations

import re

# Letter-context repairs: a digit wedged between letters is an OCR misread
# of a letter, not a digit. Measured classes on diag_extract_pipeline
# (seeds 5251/6260): '0rigin', 'Fairview, 0H', 'AIice', 'siIva@', 'lndex',
# 'ImPortant SupPort'.
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
