"""Held-out form family (a copy of
ocr_system_tpu/training/synth_forms_heldout.py; pure Python, so its specs
equal the JAX package's at every seed): layout conventions + vocabulary
DISJOINT from training/synth_forms.py, for out-of-family extraction
evaluation.

Round-2 verdict: the extractor's F1 0.954 was measured on forms from the
same generator that produced its training data (noise rate the only
held-out axis) — a distribution-shift eval was missing. The reference's
extraction bar is Gemini, which generalizes to arbitrary forms
(gemini_service.py:235-364), so the rebuild publishes both in-family and
held-out-family numbers.

What is deliberately different from the training family:
  - form types + key vocabulary never seen in training
    (_FORM_CONTENT has no "Shipping Manifest"/"Insurance Claim"/... and
    none of these field keys),
  - layout conventions the training generator never emits: tab-stop
    right-aligned values, dotted leader lines between key and value,
    ALL-CAPS label rows with indented values, three-column blocks,
  - value formats in different notations ("Jan 15, 2024" instead of
    "15/01/2024", "USD 1,234.00" instead of "$1,234.56").

Emits the same FormSpec contract as synth_forms.FormGenerator, so
rendering (render_spec), noise injection (noisy_spec) and the evaluators
all work unchanged.
"""

from __future__ import annotations

import random

from ocr_system_tpu_torch.training.synth_forms import Element, FormSpec

_MONTHS = ("Jan Feb Mar Apr May Jun Jul Aug Sep Oct Nov Dec").split()
_SURNAMES = ("Whitfield Okafor Lindqvist Duarte Kowalski Tanaka Beaumont "
             "Novak Reyes Aldridge").split()
_GIVEN = ("Edmund Freya Tobias Ingrid Marcus Celia Ruben Astrid Felix "
          "Imogen").split()
_PORTS = ("Rotterdam Hamburg Valencia Gdansk Oslo Marseille Bristol "
          "Antwerp").split()
_CARRIERS = ["Northwind Freight", "BlueKeel Lines", "Transpolar Cargo",
             "Meridian Express"]
_EVENTS = ["Annual Tech Summit", "Regional Trade Expo", "Design Forum",
           "Research Symposium"]


def _d_name(r: random.Random) -> str:
    return f"{r.choice(_GIVEN)} {r.choice(_SURNAMES)}"


def _d_date(r: random.Random) -> str:
    return f"{r.choice(_MONTHS)} {r.randint(1, 28)}, {r.randint(2019, 2031)}"


def _d_currency(r: random.Random) -> str:
    return f"USD {r.randint(10, 99999):,}.{r.randint(0, 99):02d}"


def _d_number(r: random.Random) -> str:
    return (f"{r.choice('KLMNPQ')}{r.choice('XYZW')}-"
            f"{r.randint(100, 999)}-{r.randint(10, 99)}")


def _d_phone(r: random.Random) -> str:
    return f"+44 {r.randint(1000, 9999)} {r.randint(100000, 999999)}"


def _d_email(r: random.Random) -> str:
    return (f"{r.choice(_GIVEN).lower()}.{r.choice(_SURNAMES).lower()}"
            f"@{r.choice(['borealis', 'keelworks', 'meridian'])}.org")


def _d_text(r: random.Random) -> str:
    return r.choice(
        ["pending review", "priority handling", "standard terms",
         "see attachment", "hold at terminal", "approved as noted"]
    )


def _d_port(r: random.Random) -> str:
    return r.choice(_PORTS)


def _d_carrier(r: random.Random) -> str:
    return r.choice(_CARRIERS)


def _d_event(r: random.Random) -> str:
    return r.choice(_EVENTS)


_GEN = {
    "name": _d_name, "date": _d_date, "currency": _d_currency,
    "number": _d_number, "phone": _d_phone, "email": _d_email,
    "text": _d_text, "port": _d_port, "carrier": _d_carrier,
    "event": _d_event,
}

# form types + key vocab disjoint from synth_forms._FORM_CONTENT
_HELDOUT_CONTENT: dict[str, tuple[list[str], list[tuple[str, str]]]] = {
    "Shipping Manifest": (
        ["SHIPPING MANIFEST", "Cargo Manifest", "Freight Declaration"],
        [
            ("Manifest Code", "number"), ("Carrier", "carrier"),
            ("Port of Loading", "port"), ("Port of Discharge", "port"),
            ("Departure", "date"), ("Arrival Estimate", "date"),
            ("Declared Weight", "text"), ("Freight Charge", "currency"),
            ("Consignee", "name"), ("Handling Notes", "text"),
        ],
    ),
    "Insurance Claim": (
        ["INSURANCE CLAIM", "Claim Submission Sheet", "Loss Report"],
        [
            ("Claim ID", "number"), ("Policy Holder", "name"),
            ("Incident Date", "date"), ("Adjuster", "name"),
            ("Claimed Sum", "currency"), ("Deductible", "currency"),
            ("Contact Line", "phone"), ("Settlement Status", "text"),
        ],
    ),
    "Event Registration": (
        ["Event Registration Card", "Attendee Sheet", "REGISTRATION"],
        [
            ("Event Name", "event"), ("Attendee", "name"),
            ("Badge Code", "number"), ("Arrival Day", "date"),
            ("Dietary Notes", "text"), ("Organisation Mail", "email"),
            ("Registration Fee", "currency"),
        ],
    ),
    "Expense Report": (
        ["EXPENSE REPORT", "Reimbursement Sheet", "Travel Cost Summary"],
        [
            ("Report Ref", "number"), ("Employee", "name"),
            ("Trip Start", "date"), ("Trip End", "date"),
            ("Mileage Cost", "currency"), ("Lodging Cost", "currency"),
            ("Approver", "name"), ("Cost Centre", "number"),
        ],
    ),
}

HELDOUT_TYPE_NAMES = tuple(_HELDOUT_CONTENT)


class HeldoutFormGenerator:
    """Same .generate(size) -> FormSpec contract as FormGenerator, over the
    disjoint family. Layout styles (per field, chosen randomly):

      A. tab-stop: key left, value RIGHT-ALIGNED at a fixed column
      B. dotted leader: "Key", a leader run of dots, then the value
      C. caps label row: "KEY" (upper-cased) with the value indented below
      D. three-column block: three key-above/value-below cells per row
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def generate(self, size: int = 960) -> FormSpec:
        r = self.rng
        form_type = r.choice(HELDOUT_TYPE_NAMES)
        titles, field_pool = _HELDOUT_CONTENT[form_type]
        margin = max(int(size * 0.07), 20)  # wider margins than training
        char_w = 0.58
        elements: list[Element] = []
        pairs: list[tuple[str, str, str]] = []

        def em(text, x, y, fs, role, ftype="text", pair_id=-1, bold=False):
            w = max(len(text) * char_w * fs, fs * 0.6)
            elements.append(
                Element(text, x, y, x + w, y + fs * 1.25, role, ftype,
                        pair_id, fs, bold)
            )
            return elements[-1]

        y = margin
        tfs = r.randint(size // 36, size // 26)
        title = r.choice(titles)
        em(title, margin, y, tfs, "other", bold=True)
        y += int(tfs * 2.4)

        fs = r.randint(max(size // 60, 12), max(size // 46, 15))
        tab_x = int(size * r.uniform(0.55, 0.72))  # tab stop for style A
        n_fields = r.randint(5, min(9, len(field_pool)))
        chosen = r.sample(field_pool, n_fields)
        style_pool = ["tab", "leader", "caps", "threecol"]
        block_style = r.choice(style_pool)  # one convention per form

        i = 0
        while i < len(chosen) and y < size - margin - 3 * fs:
            key, ftype = chosen[i]
            value = _GEN[ftype](r)
            pid = len(pairs)
            if block_style == "threecol" and i + 2 < len(chosen):
                cw = (size - 2 * margin) // 3
                used = 0
                for c in range(3):
                    if i >= len(chosen):
                        break
                    k2, ft2 = chosen[i]
                    v2 = _GEN[ft2](r)
                    x = margin + c * cw
                    em(k2, x, y, fs, "key", ft2, len(pairs))
                    em(v2, x + r.randint(0, fs), y + int(fs * 1.5), fs,
                       "value", ft2, len(pairs))
                    pairs.append((k2, v2, ft2))
                    i += 1
                    used += 1
                y += int(fs * 3.4)
                continue
            if block_style == "tab":
                em(key, margin, y, fs, "key", ftype, pid)
                vx = max(tab_x, margin + int(len(key) * char_w * fs) + 10)
                em(value, vx, y, fs, "value", ftype, pid)
                y += int(fs * r.uniform(1.7, 2.4))
            elif block_style == "leader":
                ke = em(key, margin, y, fs, "key", ftype, pid)
                vx = int(size * 0.62)
                n_dots = max(int((vx - ke.x1 - 10) / (char_w * fs)), 3)
                em("." * n_dots, ke.x1 + 6, y, fs, "other")
                em(value, vx, y, fs, "value", ftype, pid)
                y += int(fs * r.uniform(1.7, 2.4))
            else:  # caps
                em(key.upper(), margin, y, fs, "key", ftype, pid, bold=True)
                em(value, margin + int(fs * 1.5), y + int(fs * 1.45), fs,
                   "value", ftype, pid)
                y += int(fs * 3.2)
            pairs.append((key, value, ftype))
            i += 1

        if r.random() < 0.5:
            em(r.choice(["Retain a copy for your records.",
                         "Submit within thirty days.",
                         "All figures in account currency."]),
               margin, size - margin - fs, max(fs - 2, 10), "other")

        return FormSpec(
            size=size, elements=elements, form_type=form_type,
            pairs=pairs, table_lines=[],
        )
