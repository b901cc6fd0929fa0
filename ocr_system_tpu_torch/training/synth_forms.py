"""Structured synthetic form generator (a copy of
ocr_system_tpu/training/synth_forms.py: ``FormGenerator``, the noise
functions and ``spec_to_tokens`` are pure Python and numpy and equal the
JAX package's output byte for byte at a seed; ``render_spec`` imports PIL
when called).

The reference outsources extraction quality to Gemini
(gemini_service.py:235-364) and has no training data at all; the TPU rebuild
owns a local extraction model, and this module is its data engine. It
generates form SPECS — texts + boxes + roles + field types + a form-type
label — that serve three consumers:

  1. layout-extractor training tokens (`spec_to_tokens`): no pixel rendering
     needed, so fresh data streams at ~1000 pages/s on the 1-core host
     instead of ~1 page/s for full renders,
  2. detector training pages (`render_spec`): far more layout diversity than
     training/synth.render_page (two-column forms, separated key/value
     boxes, tables with ruled lines, titles, footers),
  3. extraction evaluation (`spec_to_word_boxes` + `spec_ocr_text` +
     ground-truth pairs) with OCR-noise injection — the honest benchmark the
     round-1 "F1 1.00 on clean colon-separated docs" eval was not.

The crucial property: a configurable fraction of key/value pairs is laid out
in SEPARATE boxes with no ":" separator (same-row or stacked), exactly the
geometry real forms use. A text-only rule tier cannot recover those pairs;
a layout-aware model can — this is what makes the neural tier earn its keep.
"""

from __future__ import annotations

import math
import random
import zlib
from dataclasses import dataclass, field

import numpy as np

from ocr_system_tpu_torch.models.charsets import Charset

# must match models/layout_extractor.py
_TAG_O, _TAG_BK, _TAG_IK, _TAG_BV, _TAG_IV = range(5)


@dataclass
class Element:
    """One drawable text run on the page."""

    text: str
    x0: float
    y0: float
    x1: float
    y1: float
    role: str  # "key" | "value" | "kv" (inline "Key: Value") | "other"
    field_type: str = "text"
    pair_id: int = -1
    font_size: int = 18
    bold: bool = False


@dataclass
class FormSpec:
    size: int
    elements: list[Element]
    form_type: str
    # ground truth: (key, value, field_type) — key WITHOUT trailing ':'
    pairs: list[tuple[str, str, str]] = field(default_factory=list)
    table_lines: list[tuple[float, float, float, float]] = field(
        default_factory=list
    )  # ruled lines (x0, y0, x1, y1) to draw
    # pair indices whose key/value element could NOT be drawn (would run off
    # the page) — render_spec fills this; eval truth must exclude them (an
    # undrawn value is unreadable by ANY OCR, so counting it as MISSING
    # penalizes the engine for pixels that do not exist)
    dropped_pair_ids: set[int] = field(default_factory=set)


# ---------------------------------------------------------------- content

_FIRST = ("John Mary Wei Priya Carlos Anna Leila Tom Grace Raj Maria Ahmed "
          "Sofia Ivan Nina Pedro Alice Omar Jane Hans").split()
_LAST = ("Smith Garcia Chen Patel Johnson Brown Silva Khan Mueller Rossi "
         "Tanaka Novak Costa Dubois Larsen Olsen Kim Das Reyes Wong").split()
_STREETS = ["Main Street", "Oak Avenue", "Park Road", "Elm Drive",
            "Lake View", "Hill Crescent", "Station Road", "Market Square"]
_CITIES = ("Springfield Riverton Fairview Georgetown Arlington Clinton "
           "Salem Madison Dover Jackson").split()
_STATES = "IL CA NY TX WA OR FL OH MI GA".split()
_WORDS = ("service agreement payment delivery quality standard annual "
          "monthly request approved pending general office support item "
          "product notes remarks additional important required optional").split()
_COMPANIES = ("Acme Corp;Global Services Ltd;Nimbus Industries;"
              "Vertex Solutions;Orion Supplies Inc;Cedar & Stone LLC").split(";")


# Open-vocabulary pseudo-words: the extractor must tag keys/names/text from
# typography and geometry, not a memorized lexicon (round-3 held-out eval:
# F1 collapsed to ~0.01 when every training token came from fixed pools —
# the model had learned the vocabulary, not the structure).
_SYL = ("ba be bi bo bu da de di do du fa fe fi fo ga ge gi go ka ke ki ko "
        "ku la le li lo lu ma me mi mo mu na ne ni no nu pa pe pi po ra re "
        "ri ro ru sa se si so su ta te ti to tu va ve vi vo za zo wen ler "
        "ton ker mar vis nor del gar hal sen ric dam fort berg stein wick "
        "shaw croft").split()


def _pseudo_word(r: random.Random, min_syl: int = 2, max_syl: int = 3) -> str:
    return "".join(r.choice(_SYL) for _ in range(r.randint(min_syl, max_syl)))


def _gen_name(r: random.Random) -> str:
    if r.random() < 0.35:
        return (f"{_pseudo_word(r).capitalize()} "
                f"{_pseudo_word(r, 2, 4).capitalize()}")
    return f"{r.choice(_FIRST)} {r.choice(_LAST)}"


def _gen_email(r: random.Random) -> str:
    user = r.choice(_FIRST).lower()
    if r.random() < 0.5:
        user += f".{r.choice(_LAST).lower()}"
    dom = r.choice(["example.com", "acme.com", "mail.org", "corp.net"])
    return f"{user}@{dom}"


def _gen_phone(r: random.Random) -> str:
    a, b, c = r.randint(200, 999), r.randint(100, 999), r.randint(1000, 9999)
    if r.random() < 0.25:  # international formats (validator: digit count)
        return (f"+{r.randint(30, 49)} {r.randint(1000, 9999)} "
                f"{r.randint(100000, 999999)}")
    return r.choice(
        [f"({a}) {b}-{c}", f"{a}-{b}-{c}", f"+1 {a} {b} {c}", f"{a}.{b}.{c}"]
    )


def _gen_date(r: random.Random) -> str:
    d, m, y = r.randint(1, 28), r.randint(1, 12), r.randint(1990, 2030)
    months = ("Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov Dec").split()
    # every variant here parses under service/validation.validate_date —
    # synth values labeled "date" must validate as dates
    return r.choice(
        [
            f"{d:02d}/{m:02d}/{y}",
            f"{y}-{m:02d}-{d:02d}",
            f"{months[m - 1]} {d}, {y}",
        ]
    )


def _gen_currency(r: random.Random) -> str:
    amount = (f"{r.randint(1, 999)}.{r.randint(0, 99):02d}"
              if r.random() < 0.3
              else f"{r.randint(1000, 99999):,}.{r.randint(0, 99):02d}")
    roll = r.random()
    if roll < 0.6:
        return f"${amount}"
    if roll < 0.85:  # ISO-code prefix (validator extracts the numeric part)
        return f"{r.choice(['USD', 'EUR', 'GBP', 'CAD'])} {amount}"
    return f"{amount} {r.choice(['USD', 'EUR'])}"


def _gen_number(r: random.Random) -> str:
    # mostly plain numerics (they must pass validate_number); prefixed
    # reference codes stay in the mix at a rate the >90%-validates
    # invariant tolerates
    if r.random() < 0.7:
        return str(r.randint(1, 999999))
    if r.random() < 0.4:  # letter-coded refs ("KX-812-47" style)
        letters = "".join(r.choice("KLMNPQRSTVWXYZ") for _ in range(2))
        return f"{letters}-{r.randint(100, 999)}-{r.randint(10, 99)}"
    prefix = r.choice(["INV-", "PO-", "REF-", "ID ", ""])
    return f"{prefix}{r.randint(2020, 2030)}-{r.randint(1, 9999):04d}"


def _gen_address(r: random.Random) -> str:
    return (
        f"{r.randint(1, 9999)} {r.choice(_STREETS)}, "
        f"{r.choice(_CITIES)}, {r.choice(_STATES)} {r.randint(10000, 99999)}"
    )


def _gen_checkbox(r: random.Random) -> str:
    return r.choice(["Yes", "No", "X", "[x]", "checked", "N/A"])


def _gen_signature(r: random.Random) -> str:
    # sentinel: signature VALUES render as handwriting squiggles, not text
    # (render_spec._draw_squiggle) — the engine's pixel-driven handwriting
    # detector is what turns them into fields (BASELINE config 4;
    # reference: Gemini reads signature presence from the page image,
    # gemini_service.py:235-364)
    return "signed"


# Devanagari form content (BASELINE config 3 extended to extraction: the
# reference's Gemini reads Hindi forms as readily as English ones, so the
# local extractor must train on Devanagari keys/values too). Real Hindi
# form vocabulary plus open-vocab pseudo-words from common syllables —
# same anti-memorization rationale as _pseudo_word. Numbers, dates and
# currency stay ASCII (Indian forms overwhelmingly use ASCII digits).
_WORDS_DEVA = (
    "नाम पता फोन तारीख राशि कुल चालान संख्या ग्राहक हस्ताक्षर "
    "भुगतान खाता शहर राज्य देश विवरण मात्रा मूल्य कर देय शेष "
    "आवेदन प्रपत्र जन्म ईमेल कंपनी सेवा वस्तु आदेश रसीद बिल"
).split()
_SYL_DEVA = ("क खा गी चु जे तो दा नि पी बु मे रो ला वि सा ह "
             "ना मा रा ता बा शा दी नी").split()


def _pseudo_word_deva(r: random.Random) -> str:
    return "".join(r.choice(_SYL_DEVA) for _ in range(r.randint(2, 3)))


def _gen_name_deva(r: random.Random) -> str:
    return f"{_pseudo_word_deva(r)} {_pseudo_word_deva(r)}"


def _gen_text_deva(r: random.Random) -> str:
    pool = _WORDS_DEVA if r.random() < 0.6 else None
    return " ".join(
        (r.choice(pool) if pool else _pseudo_word_deva(r))
        for _ in range(r.randint(1, 3))
    )


def _gen_text(r: random.Random) -> str:
    if r.random() < 0.3:
        words = [_pseudo_word(r) for _ in range(r.randint(1, 3))]
    else:
        words = [r.choice(_WORDS) for _ in range(r.randint(1, 3))]
    # a third of text values are Title Case: held-out families use values
    # like 'Research Symposium' that LOOK like keys — without key-shaped
    # values in training the extractor tags any title-cased multiword run
    # as a key (round-3 held-out diagnosis: 'Research Symposium' -> K)
    if r.random() < 0.35:
        words = [w.capitalize() for w in words]
    return " ".join(words)


_VALUE_GEN = {
    "name": _gen_name,
    "email": _gen_email,
    "phone": _gen_phone,
    "date": _gen_date,
    "currency": _gen_currency,
    "number": _gen_number,
    "address": _gen_address,
    "checkbox": _gen_checkbox,
    "signature": _gen_signature,
    "text": _gen_text,
}

# Devanagari-form overrides: textual values switch script; numbers, dates,
# currency, emails, phones and checkbox sentinels stay ASCII (real Indian
# forms use ASCII digits and Latin emails)
_VALUE_GEN_DEVA = {
    **_VALUE_GEN,
    "name": _gen_name_deva,
    "text": _gen_text_deva,
    "address": _gen_text_deva,
}

# (title pool, field pool) per form type; titles carry the keywords
# extract/rules.infer_form_type matches, so both tiers can classify
_FORM_CONTENT: dict[str, tuple[list[str], list[tuple[str, str]]]] = {
    "Invoice": (
        ["INVOICE", "Tax Invoice", "Invoice Statement"],
        [
            ("Invoice Number", "number"), ("Invoice Date", "date"),
            ("Due Date", "date"), ("Vendor", "name"), ("Customer", "name"),
            ("Subtotal", "currency"), ("Tax", "currency"),
            ("Total Amount", "currency"), ("Payment Method", "text"),
            ("Email", "email"), ("Phone", "phone"),
            ("Billing Address", "address"),
        ],
    ),
    "Receipt": (
        ["RECEIPT", "Payment Receipt", "Sales Receipt"],
        [
            ("Receipt Number", "number"), ("Date", "date"),
            ("Cashier", "name"), ("Amount Paid", "currency"),
            ("Change", "currency"), ("Payment Method", "text"),
            ("Store Phone", "phone"),
        ],
    ),
    "Application Form": (
        ["Job Application Form", "Membership Application", "APPLICATION FORM"],
        [
            ("Full Name", "name"), ("Date of Birth", "date"),
            ("Email", "email"), ("Phone Number", "phone"),
            ("Address", "address"), ("Position", "text"),
            ("Signature", "signature"), ("Date", "date"),
            ("Referred By", "name"),
        ],
    ),
    "Medical Form": (
        ["Patient Intake Form", "Medical History Form", "Clinic Registration"],
        [
            ("Patient Name", "name"), ("Date of Birth", "date"),
            ("Insurance ID", "number"), ("Physician", "name"),
            ("Allergies", "text"), ("Blood Type", "text"),
            ("Emergency Contact", "phone"), ("Visit Date", "date"),
        ],
    ),
    "Survey": (
        ["Customer Survey", "Feedback Questionnaire", "Satisfaction Survey"],
        [
            ("Respondent", "name"), ("Date", "date"),
            ("Satisfied", "checkbox"), ("Would Recommend", "checkbox"),
            ("Comments", "text"), ("Contact Email", "email"),
        ],
    ),
    "Purchase Order": (
        ["PURCHASE ORDER", "P.O. Form"],
        [
            ("PO Number", "number"), ("Order Date", "date"),
            ("Supplier", "name"), ("Ship To", "address"),
            ("Total", "currency"), ("Approved By", "name"),
            ("Delivery Date", "date"),
        ],
    ),
    "Tax Form": (
        ["Tax Return Form", "VAT Declaration", "Income Tax Worksheet"],
        [
            ("Tax Year", "number"), ("Taxpayer Name", "name"),
            ("Filing Status", "text"), ("Gross Income", "currency"),
            ("Deductions", "currency"), ("Tax Due", "currency"),
            ("Signature", "signature"),
        ],
    ),
    "Contract": (
        ["Service Contract", "Lease Agreement", "Employment Contract"],
        [
            ("Party A", "name"), ("Party B", "name"),
            ("Effective Date", "date"), ("Term", "text"),
            ("Monthly Fee", "currency"), ("Signature", "signature"),
            ("Witness", "name"),
        ],
    ),
    "Unknown": (
        ["General Form", "Information Sheet", "Data Record"],
        [
            ("Name", "name"), ("Date", "date"), ("Email", "email"),
            ("Phone", "phone"), ("Reference", "number"),
            ("Amount", "currency"), ("City", "text"), ("Notes", "text"),
        ],
    ),
}

FORM_TYPE_NAMES = tuple(_FORM_CONTENT)


# ---------------------------------------------------------------- generator


class FormGenerator:
    """Randomized form-spec generator with layout-style mixtures."""

    def __init__(
        self,
        seed: int = 0,
        colon_fraction: float = 0.4,
        deva_fraction: float = 0.15,
    ):
        self.rng = random.Random(seed)
        # fraction of separated key boxes that still carry a ':' suffix
        # (those merge into rules-parseable lines; the rest are the
        # geometry-only cases where the layout model must win)
        self.colon_fraction = colon_fraction
        # fraction of forms whose keys + textual values are Devanagari
        # (numbers/dates/currency stay ASCII like real Indian forms) —
        # Gemini parity: the reference extracts Hindi forms transparently
        self.deva_fraction = deva_fraction

    # key-vocabulary generalization: a slice of training forms uses RANDOM
    # synthetic keys so the extractor cannot memorize the key inventory and
    # must tag from geometry/typography (round-3 held-out eval: F1 craters
    # to ~0.06 on unseen keys when every training key comes from the fixed
    # _FORM_CONTENT pools)
    RANDOM_KEY_FRACTION = 0.60
    _KEY_WORDS = ("case batch region window carrier segment account permit "
                  "channel unit lot route zone shift contact entry office "
                  "project code period cycle status owner handler origin "
                  "margin sector district badge desk source branch index "
                  "license grade tier class level group series mark title").split()

    def _random_field_pool(self, r: random.Random) -> list[tuple[str, str]]:
        types = list(_VALUE_GEN)
        pool = []
        seen = set()
        for _ in range(12):
            n = r.randint(1, 3)

            def word():
                # half the key words are open-vocabulary pseudo-words so no
                # finite key lexicon exists to memorize
                return (_pseudo_word(r).capitalize() if r.random() < 0.5
                        else r.choice(self._KEY_WORDS).capitalize())

            if n >= 2 and r.random() < 0.2:
                # connector-phrase keys ("Port of Loading" shape): the
                # lowercase middle word must still tag as I-KEY
                key = f"{word()} {r.choice(['of', 'for', 'per'])} {word()}"
            else:
                key = " ".join(word() for _ in range(n))
            if key in seen:
                continue
            seen.add(key)
            pool.append((key, r.choice(types)))
        return pool

    def _deva_field_pool(self, r: random.Random) -> list[tuple[str, str]]:
        """Devanagari keys (real Hindi form words + open-vocab pseudo-words)
        with value types whose textual generators switch to Devanagari in
        generate() via _VALUE_GEN_DEVA."""
        pool: list[tuple[str, str]] = []
        seen: set[str] = set()
        types = list(_VALUE_GEN)
        for _ in range(12):
            words = [
                (r.choice(_WORDS_DEVA) if r.random() < 0.6
                 else _pseudo_word_deva(r))
                for _ in range(r.randint(1, 2))
            ]
            key = " ".join(words)
            if key in seen:
                continue
            seen.add(key)
            pool.append((key, r.choice(types)))
        return pool

    def generate(self, size: int = 960) -> FormSpec:
        r = self.rng
        deva = r.random() < self.deva_fraction
        form_type = r.choice(FORM_TYPE_NAMES)
        titles, field_pool = _FORM_CONTENT[form_type]
        if deva:
            # Hindi forms: type label space stays Latin -> "Unknown"
            form_type = "Unknown"
            titles = [r.choice(("आवेदन प्रपत्र", "चालान", "रसीद", "विवरण"))]
            field_pool = self._deva_field_pool(r)
        elif r.random() < self.RANDOM_KEY_FRACTION:
            form_type = "Unknown"
            titles = _FORM_CONTENT["Unknown"][0]
            field_pool = self._random_field_pool(r)
        # margins vary page to page (real scans do too; a fixed margin let
        # the extractor memorize the key column's absolute x position)
        margin = max(int(size * r.uniform(0.03, 0.09)), 16)
        char_w = 0.58  # DejaVu average advance / font size
        elements: list[Element] = []
        pairs: list[tuple[str, str, str]] = []
        table_lines: list[tuple[float, float, float, float]] = []

        def em(text, x, y, fs, role, ftype="text", pair_id=-1, bold=False):
            w = max(len(text) * char_w * fs, fs * 0.6)
            elements.append(
                Element(text, x, y, x + w, y + fs * 1.25, role, ftype,
                        pair_id, fs, bold)
            )
            return elements[-1]

        y = margin + r.randint(0, size // 20)

        # title
        tfs = r.randint(size // 40, size // 26)
        title = r.choice(titles)
        tx = margin if r.random() < 0.5 else size // 2 - int(
            len(title) * char_w * tfs / 2
        )
        em(title, max(tx, margin), y, tfs, "other", bold=True)
        y += int(tfs * 2.0)

        # fields
        n_fields = r.randint(4, min(9, len(field_pool)))
        chosen = r.sample(field_pool, n_fields)
        fs = r.randint(max(size // 64, 12), max(size // 44, 16))
        n_cols_kv = 1
        if size >= 640 and r.random() < 0.45:
            n_cols_kv = r.choice([2, 2, 3])  # held-out family runs 3-col
        col_w = (size - 2 * margin - 30 * (n_cols_kv - 1)) // n_cols_kv
        cols_y = [y] * n_cols_kv
        row_gap = int(fs * r.uniform(1.1, 2.2))

        # real forms usually follow ONE layout convention for every field
        # (the held-out family does); a per-field roll alone under-trains
        # the whole-page-coherent geometry, so a third of forms lock one
        # style for all fields
        locked_style = r.random() if r.random() < 0.5 else None

        def em_value_below(value, x, cy, ftype, pid, indent):
            """Value on the row below its key, COLUMN-aware: a value wider
            than its column would otherwise collide with the next column's
            text — det then reads one glued blob ('mary novakbiood:type')
            and BOTH fields die. Right-align when it fits the column at
            all; place deliberately off-page when it cannot (render drops
            it, dropped_pair_ids excludes the pair from truth)."""
            vw = len(value) * char_w * fs
            vx = x + indent
            vy = cy + int(fs * 1.4)
            col_end = x + col_w
            if vx + vw > col_end:
                vx = col_end - vw if vw <= col_w else size + 8
            em(value, max(vx, 0) if vx <= size else vx, vy, fs,
               "value", ftype, pid)
            return vy

        for slot, (key, ftype) in enumerate(chosen):
            value = (_VALUE_GEN_DEVA if deva else _VALUE_GEN)[ftype](r)
            col = slot % len(cols_y)
            x = margin + col * (col_w + 30)
            col_end = x + col_w
            cy = cols_y[col]
            if cy > size - margin - 3 * fs:
                continue  # page full
            if len(key) * char_w * fs > col_w:
                continue  # key itself can't fit the column: skip the slot
                # (a key drawn into the next column glues two labels for
                # det — 'levei mokese pedine hiandler', diag r4 seed 6260)
            pid = len(pairs)  # pair_id == index into spec.pairs
            style = locked_style if locked_style is not None else r.random()
            if style < 0.30:
                # inline "Key: Value" in one box — unless it overflows the
                # column (cross-column collision): then key inline, value
                # wrapped below
                text = f"{key}: {value}"
                if x + len(text) * char_w * fs <= col_end:
                    em(text, x, cy, fs, "kv", ftype, pid)
                    cols_y[col] = cy + fs + row_gap
                else:
                    em(f"{key}:", x, cy, fs, "key", ftype, pid)
                    vy = em_value_below(value, x, cy, ftype, pid,
                                        r.randint(0, fs))
                    cols_y[col] = vy + fs + row_gap
            elif style < 0.60:
                # key box + value box on the same row (the rules-hard case)
                ktext = key + (":" if r.random() < self.colon_fraction else "")
                ke = em(ktext, x, cy, fs, "key", ftype, pid)
                gap = r.randint(int(fs * 0.8), int(fs * 4))
                vw = len(value) * char_w * fs
                # clamp to the COLUMN, not the page: a col-1 value drawn
                # into col 2's x-range glued two fields for det
                vx = min(ke.x1 + gap, col_end - vw)
                if vx < ke.x1 + 4:
                    # value can't fit on the row (narrow column + long
                    # value): wrap below the key like real forms do. The
                    # old max() clamp pushed it off the right page edge —
                    # render skipped it but the pair stayed in truth, so
                    # eval demanded text that was never drawn (doc-8 class
                    # MISSING losses in diag_extract_pipeline)
                    vy = em_value_below(value, x, cy, ftype, pid,
                                        r.randint(0, fs))
                    cols_y[col] = vy + fs + row_gap
                else:
                    em(value, vx, cy, fs, "value", ftype, pid)
                    cols_y[col] = cy + fs + row_gap
            elif style < 0.78:
                # key above, value below
                ktext = key + (":" if r.random() < self.colon_fraction else "")
                em(ktext, x, cy, fs, "key", ftype, pid)
                vy = em_value_below(value, x, cy, ftype, pid,
                                    r.randint(0, fs))
                cols_y[col] = vy + fs + row_gap
            elif style < 0.86:
                # tab-stop: value at a fixed right column, wide separation
                # (common on statements; round-3 held-out family showed the
                # extractor had never seen it)
                ke = em(key, x, cy, fs, "key", ftype, pid)
                vx = min(x + int(col_w * r.uniform(0.55, 0.75)),
                         col_end - int(len(value) * char_w * fs))
                if vx < ke.x1 + 4:  # clamp collided with the key: wrap below
                    vy = em_value_below(value, x, cy, ftype, pid,
                                        r.randint(0, fs))
                    cols_y[col] = vy + fs + row_gap
                else:
                    em(value, vx, cy, fs, "value", ftype, pid)
                    cols_y[col] = cy + fs + row_gap
            elif style < 0.93:
                # dotted leader between key and value
                ke = em(key, x, cy, fs, "key", ftype, pid)
                vx = min(x + int(col_w * r.uniform(0.55, 0.7)),
                         col_end - int(len(value) * char_w * fs))
                if vx < ke.x1 + 12:  # no room for dots+value: wrap below
                    vy = em_value_below(value, x, cy, ftype, pid,
                                        r.randint(0, fs))
                    cols_y[col] = vy + fs + row_gap
                else:
                    n_dots = max(int((vx - ke.x1 - 8) / (char_w * fs)), 3)
                    em("." * n_dots, ke.x1 + 4, cy, fs, "other")
                    em(value, vx, cy, fs, "value", ftype, pid)
                    cols_y[col] = cy + fs + row_gap
            else:
                # ALL-CAPS bold label row, value indented below
                em(key.upper(), x, cy, fs, "key", ftype, pid, bold=True)
                vy = em_value_below(value, x, cy + int(fs * 0.05), ftype,
                                    pid, int(fs * 1.2))
                cols_y[col] = vy + fs + row_gap
            pairs.append((key, value, ftype))

        y = max(cols_y)

        # optional table (role "other" — exercised by extract/tables.py, and
        # detector diversity; not part of the KV ground truth)
        if r.random() < 0.35 and y < size - margin - 6 * fs:
            n_rows, n_cols = r.randint(2, 4), r.randint(2, 4)
            tw = size - 2 * margin
            cw = tw // n_cols
            row_h = int(fs * 1.6)
            headers = r.sample(
                ["Item", "Qty", "Price", "Total", "Code", "Desc"], n_cols
            )
            ty = y + fs
            n_fit = min(
                n_rows + 1, max((size - margin - fs - ty) // row_h, 0)
            )
            for ri in range(n_fit):
                ry = ty + ri * row_h
                for ci in range(n_cols):
                    cellx = margin + ci * cw + 4
                    if ri == 0:
                        em(headers[ci], cellx, ry, fs, "other", bold=True)
                    else:
                        gen = _VALUE_GEN[
                            "currency" if headers[ci] in ("Price", "Total")
                            else "number" if headers[ci] in ("Qty", "Code")
                            else "text"
                        ]
                        em(gen(r), cellx, ry, fs, "other")
            last_ry = ty + n_fit * row_h
            if n_fit and r.random() < 0.7:  # ruled grid
                for ri2 in range(n_fit + 1):
                    ly = ty + ri2 * row_h - 2
                    table_lines.append((margin, ly, margin + tw, ly))
                for ci2 in range(n_cols + 1):
                    table_lines.append(
                        (margin + ci2 * cw, ty - 2, margin + ci2 * cw, last_ry - 2)
                    )
            y = last_ry + int(fs * 1.5)

        # footer / noise lines
        if r.random() < 0.5:
            em("Page 1 of 1", size // 2 - 3 * fs, size - margin - fs,
               max(fs - 4, 10), "other")
        if r.random() < 0.4 and y < size - margin - 3 * fs:
            em(" ".join(r.choice(_WORDS) for _ in range(r.randint(4, 9))),
               margin, y + fs, max(fs - 2, 10), "other")

        return FormSpec(
            size=size, elements=elements, form_type=form_type,
            pairs=pairs, table_lines=table_lines,
        )


# ------------------------------------------------------------- OCR noise

# visually-plausible OCR confusions (both directions)
_CONFUSIONS = {
    "O": "0", "0": "O", "l": "1", "1": "l", "I": "l", "S": "5", "5": "S",
    "B": "8", "8": "B", "Z": "2", "2": "Z", "g": "9", "m": "n", "n": "m",
    "e": "c", "c": "e", "a": "o", "o": "a", "t": "f", "u": "v", "v": "u",
    ".": ",", ",": ".", ":": ";",
}


def noisy_chars(text: str, rng: random.Random, rate: float):
    """Yield (char, is_first_of_original_char) with substitution/deletion/
    insertion noise at `rate`. Emission-based so span tags stay aligned."""
    first = True
    for ch in text:
        roll = rng.random()
        if roll < rate * 0.2:
            continue  # deletion
        if roll < rate * 0.8:
            ch = _CONFUSIONS.get(ch) or rng.choice("abcdefghij0123456789")
        yield ch, first
        first = False
        if rng.random() < rate * 0.1:  # insertion
            yield rng.choice(".,'- "), False


def inject_ocr_noise(text: str, rng: random.Random, rate: float) -> str:
    if rate <= 0:
        return text
    return "".join(ch for ch, _ in noisy_chars(text, rng, rate))


def noisy_spec(spec: FormSpec, rng: random.Random, rate: float) -> FormSpec:
    """Return a copy of the spec with OCR noise applied to every element —
    and ground-truth pairs REBUILT from the noisy texts. This is the honest
    eval setup: the extractor is scored on recovering what the (imperfect)
    OCR stage actually produced, isolating extraction quality from OCR
    quality. For inline 'Key: Value' elements the separator is preserved so
    the pair stays well-defined; key and value halves are noised separately.
    """
    elements: list[Element] = []
    by_pair: dict[int, dict[str, str]] = {}
    for e in spec.elements:
        if e.role == "kv" and ":" in e.text:
            key, _, value = e.text.partition(":")
            nk = inject_ocr_noise(key, rng, rate)
            nv = inject_ocr_noise(value.strip(), rng, rate)
            text = f"{nk}: {nv}"
            by_pair.setdefault(e.pair_id, {})["key"] = nk.strip()
            by_pair[e.pair_id]["value"] = nv
        else:
            text = inject_ocr_noise(e.text, rng, rate)
            if e.role == "key":
                by_pair.setdefault(e.pair_id, {})["key"] = (
                    text[:-1] if text.endswith(":") else text
                ).strip()
            elif e.role == "value":
                by_pair.setdefault(e.pair_id, {})["value"] = text.strip()
        elements.append(
            Element(text, e.x0, e.y0, e.x1, e.y1, e.role, e.field_type,
                    e.pair_id, e.font_size, e.bold)
        )
    pairs = []
    for pid, (key, value, ftype) in enumerate(spec.pairs):
        noisy = by_pair.get(pid, {})
        pairs.append(
            (noisy.get("key", key), noisy.get("value", value), ftype)
        )
    return FormSpec(
        size=spec.size, elements=elements, form_type=spec.form_type,
        pairs=pairs, table_lines=list(spec.table_lines),
    )


# ------------------------------------------------------- token conversion


def _reading_order(elements: list[Element]) -> list[Element]:
    """Row-cluster by y overlap then x — mirrors engine/reading_order.py."""
    return sorted(elements, key=lambda e: (round(e.y0 / 14), e.x0))


def _char_boxes(
    text: str, x0: float, y0: float, x1: float, y1: float,
    per_word: bool,
) -> list[tuple[float, float, float, float]]:
    """Box per character: either the whole run's box, or per-WORD boxes from
    proportional slicing (spaces take the preceding word's box). Per-word
    matches what serving sees — tokenize_layout assigns each OCR word box to
    its characters — so training mixes both granularities."""
    if not per_word:
        return [(x0, y0, x1, y1)] * len(text)
    out: list[tuple[float, float, float, float]] = []
    total = max(len(text), 1)
    span = (x1 - x0) / total
    start = 0
    for i, ch in enumerate(text + " "):
        if ch == " ":
            wx0 = x0 + span * start
            wx1 = x0 + span * i
            n = i - start
            out.extend([(wx0, y0, wx1, y1)] * n)
            if i < len(text):  # the space itself
                out.append((wx0, y0, wx1, y1))
            start = i + 1
    return out[: len(text)]


def spec_to_tokens(
    spec: FormSpec,
    charset: Charset,
    max_len: int,
    noise_rate: float = 0.0,
    rng: random.Random | None = None,
    coord_jitter: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """FormSpec -> layout-extractor training arrays.

    Returns (ids, boxes, mask, tags, types, form_label). Char-level tokens
    with quantized boxes (element-level or word-level granularity, mixed
    randomly to match both detector output styles); BIO tags derive from the
    element role. OCR noise (sub/del/ins) is applied emission-side so tags
    stay aligned with the noisy stream — the model trains on the same
    distortions the real OCR stage produces.

    coord_jitter applies a random global translation + scale to every box
    (same transform page-wide): real scans place the same form at arbitrary
    offsets/zoom, and without it the model MEMORIZES absolute coordinates —
    measured round 3: held-out forms with a 7% margin scored F1 0.04 against
    a model trained only on 4%-margin pages, and shifting the very same
    pages 29 px left repaired the tagging almost completely.
    """
    from ocr_system_tpu_torch.models.layout_extractor import (
        COORD_BUCKETS,
        FIELD_TYPES,
        FORM_TYPES,
    )

    rng = rng or random.Random(0)
    type_index = {t: i for i, t in enumerate(FIELD_TYPES)}
    form_label = (
        FORM_TYPES.index(spec.form_type) if spec.form_type in FORM_TYPES else 0
    )

    ids = np.zeros((max_len,), np.int32)
    boxes = np.zeros((max_len, 4), np.int32)
    mask = np.zeros((max_len,), np.int32)
    tags = np.zeros((max_len,), np.int32)
    types = np.zeros((max_len,), np.int32)
    pos = 0
    f = COORD_BUCKETS - 1
    s = spec.size
    scale = dx = dy = 0.0
    if coord_jitter:
        scale = rng.uniform(0.82, 1.12)
        # offsets may push content toward either page edge (quant clamps)
        dx = rng.uniform(-0.06, 0.14) * s
        dy = rng.uniform(-0.06, 0.14) * s

    def quant(b):
        if coord_jitter:
            b = (b[0] * scale + dx, b[1] * scale + dy,
                 b[2] * scale + dx, b[3] * scale + dy)
        return [
            max(0, min(int(b[0] / s * f), f)),
            max(0, min(int(b[1] / s * f), f)),
            max(0, min(int(b[2] / s * f), f)),
            max(0, min(int(b[3] / s * f), f)),
        ]

    def emit_span(text, b_tag, i_tag, ftype_id, cboxes):
        """Emit one BIO span; cboxes is char-aligned. Noise is applied here:
        substitutions keep the char's box, deletions drop the emission,
        insertions reuse the current box."""
        nonlocal pos
        started = False
        ci = 0
        for orig_i, ch in enumerate(text):
            roll = rng.random() if noise_rate > 0 else 1.0
            emit: list[str] = []
            if roll < noise_rate * 0.2:
                pass  # deletion
            elif roll < noise_rate * 0.8:
                emit.append(_CONFUSIONS.get(ch) or rng.choice(
                    "abcdefghij0123456789"))
            else:
                emit.append(ch)
            if noise_rate > 0 and rng.random() < noise_rate * 0.1:
                emit.append(rng.choice(".,'- "))
            for ech in emit:
                if pos >= max_len:
                    return
                ids[pos] = charset.char_to_id(ech)
                boxes[pos] = quant(cboxes[min(orig_i, len(cboxes) - 1)])
                mask[pos] = 1
                tags[pos] = i_tag if started else b_tag
                types[pos] = ftype_id
                started = True
                pos += 1
            ci += 1

    # NOTE on a rejected augmentation: the real det stage sometimes emits
    # one box per ROW ('Name: Nina  Date: May 8' spans two pairs), and
    # training a fraction of rows with a shared union box was tried to
    # match that granularity. Measured twice (rates 0.35 and 0.25, from
    # scratch and as a fine-tune): pipeline-e2e relaxed F1 +0.02-0.03 but
    # held-out-family F1 -0.11-0.13 — identical coords for K and V tokens
    # teach the model to ignore geometry. The serving-side fix that DID
    # hold is sub-word logit pooling in extract/layout_model.element_vote.
    for e in _reading_order(spec.elements):
        if pos >= max_len:
            break
        if e.role == "value" and e.field_type == "signature":
            continue  # squiggle: no readable tokens exist for the model
        per_word = rng.random() < 0.5
        cb = _char_boxes(e.text, e.x0, e.y0, e.x1, e.y1, per_word)
        ftype_id = type_index.get(e.field_type, 0)
        if e.role == "kv" and ":" in e.text:
            k_len = e.text.index(":") + 1
            emit_span(e.text[:k_len], _TAG_BK, _TAG_IK, 0, cb[:k_len])
            emit_span(" ", _TAG_O, _TAG_O, 0, [cb[min(k_len, len(cb) - 1)]])
            emit_span(
                e.text[k_len:].strip(), _TAG_BV, _TAG_IV, ftype_id,
                cb[k_len:] or cb[-1:],
            )
        elif e.role == "key":
            emit_span(e.text, _TAG_BK, _TAG_IK, 0, cb)
        elif e.role == "value":
            emit_span(e.text, _TAG_BV, _TAG_IV, ftype_id, cb)
        else:
            emit_span(e.text, _TAG_O, _TAG_O, 0, cb)
        if pos < max_len:  # inter-element separator
            ids[pos] = charset.char_to_id(" ")
            boxes[pos] = quant(cb[-1]) if cb else 0
            mask[pos] = 1
            pos += 1
    return ids, boxes, mask, tags, types, form_label


# ------------------------------------------------- eval / serving parity


def spec_to_word_boxes(
    spec: FormSpec,
    noise_rate: float = 0.0,
    rng: random.Random | None = None,
) -> list[dict]:
    """FormSpec -> engine-shaped word boxes ({content, polygon, confidence,
    page_number}) in reading order, one box per word, with the element box
    sliced proportionally — the same artifact engine/pipeline.py feeds the
    extractor, letting extraction quality be measured without running OCR."""
    rng = rng or random.Random(0)
    out: list[dict] = []
    for e in _reading_order(spec.elements):
        if e.role == "value" and e.field_type == "signature":
            # what the engine's pixel path emits for a squiggle: a
            # handwriting box with no text (engine/handwriting.py)
            out.append(
                {
                    "type": "handwriting",
                    "content": "",
                    "confidence": 0.8,
                    "polygon": [e.x0, e.y0, e.x1, e.y0,
                                e.x1, e.y1, e.x0, e.y1],
                    "page_number": 1,
                }
            )
            continue
        words = e.text.split()
        if not words:
            continue
        total = sum(len(w) for w in words) + len(words) - 1
        xcur = e.x0
        wspan = (e.x1 - e.x0) / max(total, 1)
        for w in words:
            w_noisy = inject_ocr_noise(w, rng, noise_rate)
            x1 = xcur + wspan * len(w)
            out.append(
                {
                    "type": "word",
                    "content": w_noisy,
                    "confidence": round(1.0 - noise_rate, 4),
                    "polygon": [xcur, e.y0, x1, e.y0, x1, e.y1, xcur, e.y1],
                    "page_number": 1,
                }
            )
            xcur = x1 + wspan
    return out


def spec_ocr_text(
    spec: FormSpec,
    noise_rate: float = 0.0,
    rng: random.Random | None = None,
    row_tol: float = 10.0,
) -> str:
    """Reading-ordered line text (what the rules tier consumes): elements
    row-clustered by y and joined with spaces, mirroring what
    engine/reading_order.py would produce from the same boxes."""
    rng = rng or random.Random(0)
    rows: list[tuple[float, list[Element]]] = []
    for e in sorted(spec.elements, key=lambda e: e.y0):
        if e.role == "value" and e.field_type == "signature":
            continue  # renders as a squiggle: no OCR text exists for it
        for ry, row in rows:
            if abs(e.y0 - ry) <= row_tol:
                row.append(e)
                break
        else:
            rows.append((e.y0, [e]))
    lines = []
    for _, row in sorted(rows, key=lambda r: r[0]):
        text = " ".join(e.text for e in sorted(row, key=lambda e: e.x0))
        lines.append(inject_ocr_noise(text, rng, noise_rate))
    return "\n".join(lines)


# ---------------------------------------------------------- det rendering


def _draw_squiggle(d, e: "Element", r: random.Random) -> None:
    """Draw a handwriting-like signature squiggle inside element e's box:
    a smooth random-walk polyline with loops, pen width 2. Updates e's box
    to the drawn extent."""
    w = max(e.x1 - e.x0, 60.0)
    h = max(e.y1 - e.y0, 14.0) * r.uniform(1.2, 1.8)
    x0, y0 = e.x0, e.y0
    n = r.randint(14, 24)
    pts = []
    phase = r.uniform(0, 6.28)
    amp = h * r.uniform(0.3, 0.5)
    for i in range(n):
        t = i / (n - 1)
        x = x0 + t * w * r.uniform(0.85, 1.0)
        y = (y0 + h * 0.5
             + amp * math.sin(phase + t * r.uniform(6, 12))
             + r.uniform(-h * 0.12, h * 0.12))
        pts.append((x, y))
    d.line(pts, fill=r.randint(10, 70), width=2, joint="curve")
    if r.random() < 0.5:  # underline flourish
        uy = y0 + h * r.uniform(0.85, 1.0)
        d.line([(x0, uy), (x0 + w * 0.9, uy)], fill=r.randint(10, 70),
               width=1)
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    e.x0, e.x1 = float(min(xs)), float(max(xs))
    e.y0, e.y1 = float(min(ys)), float(max(ys))


def render_spec(spec: FormSpec, font_dir: str | None = None, augment: bool = True):
    """Render a FormSpec to a detector PageSample (image + per-element quads
    + DB targets). Element boxes are replaced by measured text bboxes so the
    detection targets match the pixels exactly."""
    from PIL import Image, ImageDraw, ImageFont

    from ocr_system_tpu_torch.training.synth import (
        discover_fonts,
        font_codepoints,
        make_db_targets,
    )
    from ocr_system_tpu_torch.training import synth as S

    # NOT hash(): str hashing is PYTHONHASHSEED-salted, which would make
    # renders differ across processes and wobble every e2e eval number
    seed_src = f"{len(spec.elements)}:{spec.size}:{spec.form_type}:" + "|".join(
        e.text for e in spec.elements[:3]
    )
    r = random.Random(zlib.crc32(seed_src.encode()) & 0xFFFF)
    fonts = discover_fonts(font_dir)
    size = spec.size
    img = Image.new("L", (size, size), r.randint(235, 255))
    d = ImageDraw.Draw(img)
    cache: dict[tuple[str, int], ImageFont.FreeTypeFont] = {}

    def font_for_text(text: str, e: Element) -> ImageFont.FreeTypeFont:
        # only fonts that can DRAW this text (a script-less font would
        # render .notdef boxes and poison det training pixels)
        need = {ord(c) for c in text if c != " "}
        pool = [f for f in fonts if need <= font_codepoints(f)] or fonts
        bold = [f for f in pool if ("Bold" in f.name) == e.bold]
        pool = bold or pool
        path = pool[(int(e.x0) * 31 + int(e.y0)) % len(pool)]
        key = (str(path), e.font_size)
        if key not in cache:
            cache[key] = ImageFont.truetype(str(path), e.font_size)
        return cache[key]

    def script_runs(text: str) -> list[str]:
        """Split into maximal single-script runs (Devanagari vs rest);
        spaces/punct attach to the run in progress. A mixed-script inline
        element ('ईमेल संख्या: CAD 96,810.69') has NO covering font — the
        old whole-element fallback rendered the Devanagari half as .notdef
        tofu, which poisoned det/extractor training pixels AND made those
        eval pairs unrecoverable by any OCR. Real Hindi invoices switch
        fonts at script boundaries; so does this renderer."""
        runs: list[str] = []
        cur: list[str] = []
        cur_deva: bool | None = None
        for ch in text:
            deva = "ऀ" <= ch <= "ॿ"
            neutral = not deva and not (ch.isascii() and ch.isalpha()
                                        and ch != " ") and not ch.isdigit()
            if cur_deva is None or deva == cur_deva or (neutral and cur):
                cur.append(ch)
                if not neutral:
                    cur_deva = deva
            else:
                runs.append("".join(cur))
                cur = [ch]
                cur_deva = deva
        if cur:
            runs.append("".join(cur))
        return runs

    def draw_element(e: Element) -> tuple | None:
        """Draw e.text, switching fonts at script boundaries when no single
        font covers the whole element. Returns the union pixel bbox."""
        need = {ord(c) for c in e.text if c != " "}
        if any(need <= font_codepoints(f) for f in fonts):
            f = font_for_text(e.text, e)
            bbox = d.textbbox((e.x0, e.y0), e.text, font=f)
            if bbox[2] >= size or bbox[3] >= size:
                return None
            d.text((e.x0, e.y0), e.text, fill=ink_fill, font=f)
            return bbox
        x = e.x0
        bb = None
        pieces = []
        for run in script_runs(e.text):
            f = font_for_text(run, e)
            rb = d.textbbox((x, e.y0), run, font=f)
            if rb[2] >= size or rb[3] >= size:
                return None
            pieces.append((x, run, f))
            bb = rb if bb is None else (
                min(bb[0], rb[0]), min(bb[1], rb[1]),
                max(bb[2], rb[2]), max(bb[3], rb[3]),
            )
            x += d.textlength(run, font=f)
        for px, run, f in pieces:
            d.text((px, e.y0), run, fill=ink_fill, font=f)
        return bb

    for x0, y0, x1, y1 in spec.table_lines:
        d.line([(x0, y0), (x1, y1)], fill=r.randint(60, 140), width=1)

    quads, texts = [], []
    spec.dropped_pair_ids.clear()  # idempotent across re-renders
    for e in spec.elements:
        if e.role == "value" and e.field_type == "signature":
            # handwriting squiggle instead of text; excluded from the det/
            # OCR truth (quads/texts) — it is NOT text, and the engine's
            # handwriting detector finds it from pixels
            _draw_squiggle(d, e, r)
            continue
        ink_fill = r.randint(0, 70)
        bbox = draw_element(e)
        if bbox is None:
            if e.pair_id >= 0:
                spec.dropped_pair_ids.add(e.pair_id)
            continue
        e.x0, e.y0, e.x1, e.y1 = map(float, bbox)
        quads.append(
            np.array(
                [[bbox[0], bbox[1]], [bbox[2], bbox[1]],
                 [bbox[2], bbox[3]], [bbox[0], bbox[3]]], np.float32,
            )
        )
        texts.append(e.text)

    arr = np.asarray(img, np.float32) / 255.0
    if augment and r.random() < 0.6:
        arr = np.clip(
            arr + np.random.default_rng(r.randrange(1 << 30)).normal(
                0, r.uniform(0.01, 0.04), arr.shape
            ).astype(np.float32),
            0, 1,
        )
    quads_arr = np.stack(quads) if quads else np.zeros((0, 4, 2), np.float32)
    shrink, smask, thresh, tmask = make_db_targets(size, quads_arr)
    return S.PageSample(
        image=np.stack([arr] * 3, axis=-1),
        quads=quads_arr,
        texts=texts,
        shrink_map=shrink,
        shrink_mask=smask,
        thresh_map=thresh,
        thresh_mask=tmask,
    )
