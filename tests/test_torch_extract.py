"""The port's extraction host code against the JAX package's, function by
function on the same inputs: the rule extractor, directives, the typed
post-correction, validation, the bounding-box matcher, the checkbox and
signature pairing of marks and handwriting, the long-document chunk split
and the chunk merge. Inputs are the committed smoke forms' OCR records
(``assets/smoke_forms_expected.json``) and values drawn with numpy from a
seed; every output must be equal."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from ocr_system_tpu.engine import handwriting as jax_hand
from ocr_system_tpu.engine import selection_marks as jax_marks
from ocr_system_tpu.extract import directives as jax_directives
from ocr_system_tpu.extract import postfix as jax_postfix
from ocr_system_tpu.extract import rules as jax_rules
from ocr_system_tpu.extract.layout_model import split_word_boxes as jax_split
from ocr_system_tpu.extract.types import ExtractedField as JaxField
from ocr_system_tpu.extract.types import ExtractionResult as JaxResult
from ocr_system_tpu.parallel.ring_attention import chunked_extract_merge as jax_merge
from ocr_system_tpu.service import bbox_matcher as jax_bbox
from ocr_system_tpu.service import validation as jax_validation
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import handwriting, selection_marks
from ocr_system_tpu_torch.extract import directives, postfix, rules
from ocr_system_tpu_torch.extract.layout_model import split_word_boxes
from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.parallel.ring_attention import chunked_extract_merge
from ocr_system_tpu_torch.service import bbox_matcher, validation
from ocr_system_tpu_torch.utils import smoke

torch.set_num_threads(1)

_, EXPECTED = smoke.smoke_forms()
RECORDS = EXPECTED["pages"]["float32"] + EXPECTED["mixed"]["float32"]
WORDS = sorted({w["content"] for r in RECORDS for w in r["word"]})
FIELD_TYPES = [t.value for t in validation.FieldType] + ["carrier"]
HAND_VALUES = [
    "697-481-915O7", "(9l9) 214-5410", "2O13-09-11", "1993 07-1M4", "Oak Avenue 12",
    "Carlos Olsen", "17,502.12 EUR", "S5O0.25", "john@acme. com", "a b@c.org",
    "meet @ the cafe. thanks", "JohnDoe@acme.com", "BlOS", "", "9846 Park Road, Fairview, 0H 15987",
    "AIice Chen", "5 lbs", "BlueKeel Lines", "ImPortant", "286.90 USD", "Jul 27, 2026",
    "NO 12345", "851 O31 8095", "omar@example:com", "carlos.chen@mailiorg",
    "ahmed.siIva@example.com", "+42 7,714 157132", "851.,231.8095", "Ml 63629",
    "WA 5971 3", "Springfield, Al 35758", "INV.-2020", "usergexample.com", "+91 9876543210",
    "12/31/2024", "31 Dec 2024", "December 31, 2024", "2024/12/31", "1,234.50", "$1,200",
    "₹ 500", "yes", "X", "unchecked", "maybe", "O'Brien-Smith", "J", "राखा शर्मा",
    "12 Main St", "123 Long Street, Springfield", "x@y", "  ", "1.2.3", "-42", "abc123",
]


def _seeded_values(n: int, seed: int) -> list[str]:
    """Values built from the committed words and confusable characters."""
    rng = np.random.default_rng(seed)
    alphabet = list("0123456789OolISBZ|.-,:;@/ ()$") + list("abcdefghijklmnopqrstuvwxyz")
    out = []
    for _ in range(n):
        if rng.random() < 0.5:
            k = int(rng.integers(1, 4))
            out.append(" ".join(rng.choice(WORDS, k)))
        else:
            out.append("".join(rng.choice(alphabet, int(rng.integers(1, 18)))))
    return out


VALUES = HAND_VALUES + _seeded_values(300, 11)


def _d(obj) -> dict:
    d = dataclasses.asdict(obj)
    d.pop("processing_time_ms", None)
    return d


# ---- postfix ----

@pytest.mark.parametrize("field_type", FIELD_TYPES)
def test_autocorrect_value_matches_jax(field_type):
    for v in VALUES:
        assert postfix.autocorrect_value(v, field_type) == jax_postfix.autocorrect_value(
            v, field_type), (v, field_type)


def test_snap_key_and_family_vote_match_jax():
    rng = np.random.default_rng(12)
    keys = [k for lex in postfix.FORM_KEY_LEXICON.values() for k in lex]
    noisy = []
    for k in keys + WORDS[:150]:
        chars = list(k)
        for _ in range(int(rng.integers(0, 3))):
            if chars:
                chars[int(rng.integers(len(chars)))] = str(rng.choice(list("aeiol1O0 ")))
        noisy.append("".join(chars))
    for k in noisy:
        for lex in [*postfix.FORM_KEY_LEXICON.values(), []]:
            for cer in (0.25, 0.34):
                assert postfix.snap_key(k, lex, cer) == jax_postfix.snap_key(k, lex, cer), k
    for i in range(60):
        sample = list(rng.choice(noisy, int(rng.integers(0, 8))))
        pred = str(rng.choice(["Unknown", *postfix.FORM_KEY_LEXICON]))
        assert postfix.infer_family_from_keys(sample, pred) == \
            jax_postfix.infer_family_from_keys(sample, pred), (sample, pred)
    assert postfix.FORM_KEY_LEXICON == jax_postfix.FORM_KEY_LEXICON


# ---- validation ----

@pytest.mark.parametrize("field_type", FIELD_TYPES)
def test_validate_field_matches_jax(field_type):
    from ocr_system_tpu.core.config import Settings as JaxSettings

    port = validation.ValidationService(Settings())
    ref = jax_validation.ValidationService(JaxSettings())
    for v in VALUES + [None]:
        for conf in (0.0, 0.3, 0.6, 0.7, 0.85, 0.99):
            assert _d(port.validate_field(v, field_type, conf)) == _d(
                ref.validate_field(v, field_type, conf)), (v, field_type, conf)


def test_validate_fields_and_finalization_match_jax():
    from ocr_system_tpu.core.config import Settings as JaxSettings

    rng = np.random.default_rng(13)
    fields = [{"key": f"f{i}", "value": str(rng.choice(VALUES)),
               "field_type": str(rng.choice(FIELD_TYPES)), "confidence": float(rng.random())}
              for i in range(200)]
    port = validation.ValidationService(Settings())
    ref = jax_validation.ValidationService(JaxSettings())
    a, b = port.validate_fields(fields), ref.validate_fields(fields)
    assert smoke.report_record(a) == smoke.report_record(b)
    assert a.is_valid == b.is_valid
    assert port.validate_before_finalization(fields[:20]) == \
        ref.validate_before_finalization(fields[:20])
    assert [t.value for t in validation.FieldType] == [t.value for t in jax_validation.FieldType]


# ---- rules ----

def _rule_texts() -> list[tuple[str, dict]]:
    """Each committed page's markdown, and seeded 'Key: Value' documents."""
    rng = np.random.default_rng(14)
    keys = [k for lex in postfix.FORM_KEY_LEXICON.values() for k in lex]
    out = [(r["markdown"], {}) for r in RECORDS]
    for _ in range(12):
        lines = []
        for _ in range(int(rng.integers(3, 15))):
            k, v = str(rng.choice(keys)), str(rng.choice(VALUES))
            sep = str(rng.choice([": ", " - ", " = ", ":", ":\n"]))
            lines.append(f"{k}{sep}{v}" if rng.random() < 0.8 else v)
        text = "\n".join(lines)
        conf = {ln.strip(): float(rng.random()) for ln in text.splitlines() if rng.random() < 0.5}
        out.append((text, conf))
    return out


RULE_TEXTS = _rule_texts()
TEMPLATES = [
    None,
    {"expected_fields": ["Invoice Number", "Total Amount", "Due Date"]},
    {"expected_fields": [{"name": "Patient Name", "field_type": "name"},
                         {"name": "Date of Birth", "field_type": "date"}, "Notes"]},
]


@pytest.mark.parametrize("k", range(len(RULE_TEXTS)))
def test_rule_extractor_matches_jax(k):
    text, conf = RULE_TEXTS[k]
    for template in TEMPLATES:
        a = rules.RuleExtractor().extract(text, conf, copy.deepcopy(template))
        b = jax_rules.RuleExtractor().extract(text, conf, copy.deepcopy(template))
        assert _d(a) == _d(b), template
    assert rules.infer_form_type(text) == jax_rules.infer_form_type(text)
    assert rules.infer_language(text) == jax_rules.infer_language(text)


def test_infer_field_type_matches_jax():
    rng = np.random.default_rng(15)
    keys = ["Email", "Phone", "DOB", "Total", "Name", "Address", "Signature", "Qty", "Notes", ""]
    for v in VALUES:
        k = str(rng.choice(keys))
        assert rules.infer_field_type(k, v) == jax_rules.infer_field_type(k, v), (k, v)
        assert rules.infer_field_type("", v) == jax_rules.infer_field_type("", v), v


# ---- directives ----

PROMPTS = [
    None, "please be thorough", "Extract only: Total Amount, Due Date",
    "Due Date is a date. Amount is a currency.", "Ignore Comments and Notes",
    "treat Contact as a phone; fields: Vendor, Invoice Number and Customer",
    "return only the Patient Name; Visit Date is a date", "extract - Party A, Party B, Term",
]


@pytest.mark.parametrize("prompt", PROMPTS)
def test_directives_match_jax(prompt):
    rng = np.random.default_rng(16)
    for template in TEMPLATES + [{"expected_fields": []}]:
        a = directives.parse_directives(prompt, copy.deepcopy(template))
        b = jax_directives.parse_directives(prompt, copy.deepcopy(template))
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        text = " ".join(rng.choice(WORDS + a.names, 40))
        logp = rng.normal(size=(len(text), 5)).astype(np.float32)
        la, lb = logp.copy(), logp.copy()
        directives.key_tag_bias(la, text, a)
        jax_directives.key_tag_bias(lb, text, b)
        np.testing.assert_array_equal(la, lb)
        raw = [(str(rng.choice(a.names + WORDS[:30])) if rng.random() < 0.8 else "",
                str(rng.choice(VALUES)), str(rng.choice(FIELD_TYPES)), float(rng.random()))
               for _ in range(12)]
        got = directives.apply_directives([ExtractedField(*f) for f in raw], a)
        want = jax_directives.apply_directives([JaxField(*f) for f in raw], b)
        assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


# ---- bounding-box matcher ----

def _layout(rec: dict, page: int, rng) -> list[dict]:
    """A page record's layout boxes as the engine emits them, with seeded
    confidences (the records keep none)."""
    return [{"type": typ, **b, "confidence": round(float(rng.uniform(0.5, 1.0)), 4),
             "page_number": page}
            for typ in smoke.LAYOUT_TYPES for b in rec[typ]]


@pytest.mark.parametrize("k", [0, 3, 6, 9])
def test_bbox_matcher_matches_jax(k):
    rng = np.random.default_rng(17 + k)
    layout = _layout(RECORDS[k], 1 + k % 3, rng)
    texts = [b["content"] for b in layout if b["content"]]
    queries = list(rng.choice(texts, 30)) + _seeded_values(30, 18 + k) + [
        " ".join(rng.choice(texts, 2)) for _ in range(10)]
    port, ref = bbox_matcher.BoundingBoxMatcher(), jax_bbox.BoundingBoxMatcher()
    for i in range(0, len(queries) - 1, 2):
        key, value = str(queries[i]), str(queries[i + 1])
        assert port.find_key_value_pair(key, value, layout) == \
            ref.find_key_value_pair(key, value, layout), (key, value)


# ---- marks and handwriting to fields ----

@pytest.mark.parametrize("k", range(len(RECORDS)))
def test_marks_and_handwriting_to_fields_match_jax(k):
    rng = np.random.default_rng(19 + k)
    layout = _layout(RECORDS[k], 1, rng)
    marks = [b for b in layout if b["type"] == "selection_mark"]
    assert selection_marks.marks_to_fields(marks, layout) == \
        jax_marks.marks_to_fields(marks, layout)
    hand = [b for b in layout if b["type"] == "handwriting"]
    # also a squiggle beside every third line, so each page pairs some
    for b in layout[::3]:
        if b["type"] == "line":
            xs, ys = b["polygon"][0::2], b["polygon"][1::2]
            x0, y0, h = max(xs) + 5, min(ys), max(ys) - min(ys)
            hand.append({"type": "handwriting", "content": "", "page_number": 1,
                         "confidence": round(float(rng.uniform(0.5, 0.95)), 4),
                         "polygon": [x0, y0, x0 + 4 * h, y0, x0 + 4 * h, y0 + h, x0, y0 + h]})
    got = handwriting.handwriting_to_fields(hand, layout)
    want = jax_hand.handwriting_to_fields(hand, layout)
    assert got == want
    keys = {str(w).lower() for w in rng.choice(WORDS, 10)}
    for sf in got:
        for value in [None, "", "signed", *rng.choice(VALUES, 6)]:
            for conf in (0.3, 0.9):
                assert handwriting.squiggle_overrides(sf, value, conf, keys) == \
                    jax_hand.squiggle_overrides(sf, value, conf, keys), (sf, value)
    for w in WORDS[:200] + ["Signoturo", "authorized by", "हस्ताक्षर"]:
        assert handwriting._has_signature_keyword(w.lower()) == \
            jax_hand._has_signature_keyword(w.lower()), w


# ---- long documents: chunk split and merge ----

@pytest.mark.parametrize("max_len,overlap", [(2048, 256), (300, 40), (64, 0)])
def test_split_word_boxes_matches_jax(max_len, overlap):
    docs = smoke.extract_documents(EXPECTED)
    words = docs["pages"][0] + docs["mixed/2"][0]
    assert split_word_boxes(words, max_len, overlap) == jax_split(words, max_len, overlap)


def test_chunked_extract_merge_matches_jax():
    rng = np.random.default_rng(20)
    keys = ["Name", "name ", "Date", "", "Total", "DATE"]
    for _ in range(20):
        chunks = []
        for _ in range(int(rng.integers(0, 5))):
            fields = [(str(rng.choice(keys)), str(rng.choice(["a", "A ", "b", "c"])), "text",
                       float(rng.random())) for _ in range(int(rng.integers(0, 6)))]
            meta = dict(form_type=str(rng.choice(["Unknown", "Invoice", "Receipt"])),
                        language=str(rng.choice(["en", "hi"])),
                        token_count=int(rng.integers(0, 2048)),
                        processing_time_ms=int(rng.integers(0, 50)),
                        success=bool(rng.random() < 0.85))
            chunks.append(([ExtractedField(*f) for f in fields], [JaxField(*f) for f in fields],
                           meta))
        got = chunked_extract_merge([ExtractionResult(fields=p, **m) for p, _, m in chunks])
        want = jax_merge([JaxResult(fields=j, **m) for _, j, m in chunks])
        assert got.to_dict() == want.to_dict()
