"""Evaluation: CER and field-extraction F1 on held-out synthetic documents
(port of ocr_system_tpu/training/evaluate.py; the same functions, defaults
and results).

These are the BASELINE.md metrics ("CER within 1% of the Azure+PaddleOCR
reference", "field-extraction F1"). The reference has no eval harness at all;
here both metrics run against the synthetic generator with held-out seeds so
they are reproducible without external data. The engines, recognizers and
extractors passed in run wherever they were built (on the card unless built
with ``device="cpu"``); the scoring is host code.

``edit_distance`` and ``infix_cer`` are the JAX module's dynamic programmes
row by row in numpy: the same integers, a few milliseconds for a whole
page's text against a whole page's output instead of seconds of Python.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

import numpy as np

from ocr_system_tpu_torch.engine.handwriting import handwriting_to_fields, squiggle_overrides
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.reading_order import canonicalize_leaders
from ocr_system_tpu_torch.extract.postfix import (
    FORM_KEY_LEXICON,
    autocorrect_value,
    clean_key,
    snap_key,
)
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.models.layout_extractor import FORM_TYPES
from ocr_system_tpu_torch.training import synth_forms as SF
from ocr_system_tpu_torch.training.synth import TextRenderer


def _codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-32-le"), np.uint32)


def _dp_last_row(rows: str, cols: str, free_prefix: bool) -> np.ndarray:
    """Last row of the Levenshtein table of ``rows`` against ``cols``
    (first row 0..m, or all 0 when a prefix of ``cols`` is free). Each row
    is vectorized: cur[j] = min(prev[j] + 1, prev[j-1] + (a != b_j)),
    then the insertion chain cur[j] = min(cur[j], cur[j-1] + 1) is
    j + a running minimum of cur[k] - k."""
    m = len(cols)
    j = np.arange(m + 1)
    prev = np.zeros(m + 1, np.int64) if free_prefix else j.copy()
    neq = _codes(rows)[:, None] != _codes(cols)[None, :]
    tmp = np.empty(m + 1, np.int64)
    for i in range(1, len(rows) + 1):
        tmp[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + neq[i - 1], out=tmp[1:])
        prev = np.minimum.accumulate(tmp - j) + j
    return prev


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    if len(a) > len(b):  # symmetric: loop over the shorter string
        a, b = b, a
    return int(_dp_last_row(a, b, free_prefix=False)[-1])


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate: edits / len(reference)."""
    if not reference:
        return 0.0 if not hypothesis else 1.0
    return edit_distance(reference, hypothesis) / len(reference)


def infix_cer(needle: str, haystack: str) -> float:
    """Best CER of `needle` against any substring of `haystack` (prefix/
    suffix of the haystack are free). A truth element that the engine
    legitimately merged into a longer line ("Date" inside "Date Nov 1,
    2013") scores by its own edits only."""
    if not needle:
        return 0.0
    if not haystack:
        return 1.0
    return int(_dp_last_row(needle, haystack, free_prefix=True).min()) / len(needle)


@dataclass
class RecEvalResult:
    n_lines: int
    mean_cer: float
    exact_match_rate: float
    samples: list[tuple[str, str]] = field(default_factory=list)


def evaluate_recognizer(
    recognizer,
    charset,
    n_lines: int = 100,
    width: int = 320,
    seed: int = 9999,
    keep_samples: int = 5,
) -> RecEvalResult:
    """Render held-out lines, recognize them as full-width crops, score CER."""
    renderer = TextRenderer(charset, seed=seed)
    cers, exact = [], 0
    samples = []
    for i in range(n_lines):
        sample = renderer.render_line(max_width=width, augment=False)
        page = (sample.image * 255).astype(np.uint8)
        quad = np.array(
            [[[0, 0], [sample.width - 1, 0], [sample.width - 1, 47], [0, 47]]],
            np.float32,
        )
        out = recognizer.recognize_page(page, quad)[0]
        # charset-normalized reference (drop chars the model can't emit)
        ref = charset.decode(charset.encode(sample.text))
        c = cer(ref, out.text)
        cers.append(c)
        exact += int(out.text == ref)
        if len(samples) < keep_samples:
            samples.append((ref, out.text))
    return RecEvalResult(
        n_lines=n_lines,
        mean_cer=float(sum(cers) / max(len(cers), 1)),
        exact_match_rate=exact / max(n_lines, 1),
        samples=samples,
    )


@dataclass
class E2EEvalResult:
    n_pages: int
    mean_page_cer: float
    line_recall: float  # fraction of truth lines matched with CER < 0.3
    forms_page_cer: float = -1.0  # mean over FORM pages (-1 if none)
    plain_page_cer: float = -1.0  # mean over plain-text pages (-1 if none)
    # CER with dot-leader tokens stripped from BOTH sides: the engine
    # canonicalizes leader runs at markdown emission (reading_order.
    # canonicalize_leaders) and eval truth matches it — this column proves
    # the canonicalization isn't hiding real-content errors
    content_page_cer: float = -1.0


def _truth_charset(engine, charset):
    """Charset used to normalize eval TRUTH text. Form pages can be Hindi
    (FormGenerator deva_fraction) and a script-ROUTING engine decodes them
    correctly — filtering the truth through the single eval charset turned
    a correctly-read Hindi form into 3.5 pure-insertion page CER once.
    Filter truth by what the ENGINE can emit: the latin∪devanagari union
    when routing is active (rec_charset=auto + Devanagari weights, as
    pipeline.TorchOCREngine._devanagari_recognizer finds them: the
    configured file, else ``<checkpoint_dir>/rec_devanagari.npz``), else
    the eval charset."""
    st = getattr(engine, "settings", None)
    if st is None or st.rec_charset != "auto":
        return charset
    deva = st.rec_checkpoint_devanagari or os.path.join(
        st.checkpoint_dir, "rec_devanagari.npz"
    )
    return get_charset("multilingual") if os.path.isfile(deva) else charset


def evaluate_end_to_end(
    engine, charset, n_pages: int = 10, size: int = 800, seed: int = 5555,
    forms_fraction: float = 0.5,
) -> E2EEvalResult:
    """Full-pipeline eval: render synthetic pages (held-out seed), run the
    engine (det + rec + reading order), score page-level CER of the ordered
    text and per-line recall. This is the BASELINE 'CER on test images'
    metric measured end-to-end rather than rec-only.

    Pages mix plain text layouts with structured forms (tables, two-column,
    separated key/value boxes) at `forms_fraction` — the document classes
    production actually sees."""
    renderer = TextRenderer(charset, seed=seed)
    form_gen = SF.FormGenerator(seed=seed + 1)
    # form specs carry Latin content; a charset that can't encode it (e.g.
    # pure Devanagari) evaluates on script-matched text pages only
    if len(charset.encode("Invoice Number 42")) < 10:
        forms_fraction = 0.0
    truth_charset = _truth_charset(engine, charset)
    page_cers = []
    content_cers = []  # leaders stripped both sides (see E2EEvalResult)
    kinds = []  # parallel to page_cers: True = form page
    matched = total_lines = 0
    for i in range(n_pages):
        is_form = i < n_pages * forms_fraction
        kinds.append(is_form)
        if is_form:
            page = SF.render_spec(form_gen.generate(size), augment=False)
        else:
            page = renderer.render_page(size=size, augment=False)
        out = engine.process_pages([PageImage((page.image * 255).astype(np.uint8), 1)])[0]
        texts = [
            truth_charset.decode(truth_charset.encode(t)) for t in page.texts
        ]
        # truth ROWS, clustered exactly like the engine's reading order
        # (same-row elements merge left-to-right) — per-element truth would
        # punish the engine for legitimately joining "Date" with its value.
        # Leader runs canonicalize exactly like engine markdown emission.
        truth_rows = [
            canonicalize_leaders(t) for t in _cluster_rows(page.quads, texts)
        ]
        page_cers.append(cer("\n".join(truth_rows), out.markdown))
        strip = lambda s: " ".join(s.replace("...", " ").split())  # noqa: E731
        content_cers.append(cer(
            "\n".join(strip(t) for t in truth_rows),
            "\n".join(strip(g) for g in out.markdown.splitlines()),
        ))
        got_lines = out.markdown.splitlines()
        for t in truth_rows:
            total_lines += 1
            if any(
                min(cer(t, g), infix_cer(t, g)) < 0.3 for g in got_lines
            ):
                matched += 1
    forms = [c for c, k in zip(page_cers, kinds) if k]
    plain = [c for c, k in zip(page_cers, kinds) if not k]
    return E2EEvalResult(
        n_pages=n_pages,
        mean_page_cer=float(sum(page_cers) / max(len(page_cers), 1)),
        line_recall=matched / max(total_lines, 1),
        forms_page_cer=float(sum(forms) / len(forms)) if forms else -1.0,
        plain_page_cer=float(sum(plain) / len(plain)) if plain else -1.0,
        content_page_cer=float(
            sum(content_cers) / max(len(content_cers), 1)
        ),
    )


def _cluster_rows(quads, texts) -> list[str]:
    """y-cluster word quads into rows (0.5x avg height tolerance, mirroring
    engine/reading_order.py), x-sort within a row, join with spaces."""
    items = [
        (float(q[:, 1].min()), float(q[:, 1].max()), float(q[:, 0].min()), t)
        for q, t in zip(quads, texts)
    ]
    if not items:
        return []
    avg_h = sum(y1 - y0 for y0, y1, _, _ in items) / len(items)
    tol = 0.5 * max(avg_h, 1.0)
    rows: list[list] = []
    for it in sorted(items, key=lambda v: v[0]):
        yc = (it[0] + it[1]) / 2
        for row in rows:
            ry = sum((r[0] + r[1]) / 2 for r in row) / len(row)
            if abs(yc - ry) <= tol:
                row.append(it)
                break
        else:
            rows.append([it])
    return [
        " ".join(t for _, _, _, t in sorted(row, key=lambda v: v[2])).strip()
        for row in rows
    ]


@dataclass
class FieldEvalResult:
    precision: float
    recall: float
    f1: float
    n_docs: int
    form_type_accuracy: float = 0.0
    # pairs whose truth key/value the shared repair canonicalization
    # CHANGED (a destructive repair corrupting both sides would otherwise
    # score as a silent true positive — this makes the repair surface
    # visible in the sweep)
    repair_changed_pairs: int = 0
    total_truth_pairs: int = 0


def _norm_key(k: str) -> str:
    return " ".join(k.rstrip(":").lower().split())


def _norm_val(v: str) -> str:
    return " ".join(v.split())


def _merge_squiggles(got: dict, hand: list[dict], boxes: list[dict]) -> None:
    """Pixel path: signature fields from handwriting boxes by label pairing,
    merged by the SHARED squiggle_overrides policy (serving and both eval
    paths use the same function)."""
    for sf in handwriting_to_fields(hand, boxes):
        k = _norm_key(sf["field_key"])
        if squiggle_overrides(sf, got.get(k), other_keys=set(got)):
            got[k] = _norm_val(sf["field_value"])


def _got_fields(result) -> dict:
    return {
        _norm_key(f.field_key): _norm_val(f.field_value)
        for f in result.fields
        if f.field_key.strip() and f.field_value.strip()
    }


def _exact_counts(got: dict, truth: dict) -> tuple[int, int, int]:
    tp = sum(truth.get(k) == v for k, v in got.items())
    fn = sum(got.get(k) != v for k, v in truth.items())
    return tp, len(got) - tp, fn


def evaluate_form_extraction(
    extractor,
    n_docs: int = 40,
    noise_rate: float = 0.03,
    page_size: int = 960,
    seed: int = 31337,
    generator=None,
) -> FieldEvalResult:
    """Field-pair F1 on held-out structured synthetic forms with OCR noise.

    Unlike evaluate_field_extraction (clean colon-separated lines — a floor
    check), these forms mix inline, same-row-separate-box and stacked
    key/value layouts plus tables and noise text, with ground truth rebuilt
    from the noisy page (training/synth_forms.noisy_spec) — the benchmark
    the reference delegates to Gemini.

    The extractor is fed whichever artifact it consumes: layout extractors
    (extract_from_layout) get word boxes + page size, text extractors get
    reading-ordered line text. Keys match case/colon-insensitively; values
    must match after whitespace collapse.

    ``generator``: any .generate(size) -> FormSpec source; pass
    synth_forms_heldout.HeldoutFormGenerator for the out-of-family eval
    (disjoint layout conventions + key vocabulary).
    """
    gen = generator or SF.FormGenerator(seed=seed)
    rng = random.Random(seed + 1)
    tp = fp = fn = 0
    form_type_hits = 0
    repair_changed = total_pairs = 0
    for _ in range(n_docs):
        spec = SF.noisy_spec(gen.generate(page_size), rng, noise_rate)
        text = SF.spec_ocr_text(spec)
        word_boxes = SF.spec_to_word_boxes(spec)
        if hasattr(extractor, "extract_from_layout"):
            result = extractor.extract_from_layout(
                word_boxes, (page_size, page_size), ocr_text=text
            )
        else:
            result = extractor.extract(text)
        # truth keys/values are the NOISY OCR readings by design (the
        # extractor is scored on recovering what OCR produced) — but the
        # extractor canonicalizes at emission (clean_key + snap_key on
        # keys, typed autocorrect_value on values; extract/postfix), so
        # truth rides the SAME canonicalization or the eval punishes a
        # correct repair. Both sides compare in repair-canonical space;
        # tagging/pairing quality is what's left.
        lex = FORM_KEY_LEXICON.get(spec.form_type, [])
        truth = {}
        for k, v, t in spec.pairs:
            if not v.strip():
                continue
            rk = _norm_key(snap_key(clean_key(k), lex))
            rv = _norm_val(autocorrect_value(v, t))
            if rk != _norm_key(k) or rv != _norm_val(v):
                repair_changed += 1
            total_pairs += 1
            truth[rk] = rv
        got = _got_fields(result)
        hand = [b for b in word_boxes if b.get("type") == "handwriting"]
        _merge_squiggles(got, hand, word_boxes)
        a, b, c = _exact_counts(got, truth)
        tp, fp, fn = tp + a, fp + b, fn + c
        # out-of-family form types are NOT in the classifier's label space
        # (models/layout_extractor.FORM_TYPES) — the correct answer for a
        # type the model was never told exists is "Unknown"
        want = (
            spec.form_type if spec.form_type in FORM_TYPES else "Unknown"
        )
        form_type_hits += int(result.form_type == want)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return FieldEvalResult(
        precision=precision, recall=recall, f1=f1, n_docs=n_docs,
        form_type_accuracy=form_type_hits / max(n_docs, 1),
        repair_changed_pairs=repair_changed, total_truth_pairs=total_pairs,
    )


def _prf(a: int, b: int, c: int) -> dict:
    p = a / max(a + b, 1)
    r = a / max(a + c, 1)
    return {
        "precision": round(p, 4),
        "recall": round(r, 4),
        "f1": round(2 * p * r / max(p + r, 1e-9), 4),
    }


def evaluate_form_extraction_e2e(
    engine,
    extractor,
    n_docs: int = 10,
    page_size: int = 960,
    seed: int = 4242,
    generator=None,
) -> dict:
    """Field-pair F1 THROUGH the real OCR pipeline.

    evaluate_form_extraction feeds the extractor synthetic word boxes with
    injected noise — it measures the extractor in isolation. This renders
    each form to pixels, runs the FULL engine (det + rec + reading order +
    pixel passes), feeds the engine's word boxes to the extractor (the
    orchestrator's exact artifact, service/orchestrator.py), merges the
    handwriting signature fields, and scores against the spec's pairs —
    the number a user of the reference's OCR->Gemini flow actually sees.

    Reports exact-match F1 and a CER-tolerant F1 (key and value within
    0.25 CER): OCR noise turns near-misses into hard misses, so the
    relaxed figure separates extraction failures from recognition noise.
    """
    gen = generator or SF.FormGenerator(seed=seed)
    tp = fp = fn = 0
    rtp = rfp = rfn = 0
    for _ in range(n_docs):
        spec = gen.generate(page_size)
        page = SF.render_spec(spec, augment=False)
        pixels = (page.image * 255).astype(np.uint8)
        out = engine.process_pages([PageImage(pixels, 1)])[0]
        words = [
            b for b in out.layout_boxes if b.get("type") == "word"
        ]
        result = extractor.extract_from_layout(
            words, (page_size, page_size), ocr_text=out.markdown
        )
        got = _got_fields(result)
        hand = [
            b for b in out.layout_boxes if b.get("type") == "handwriting"
        ]
        _merge_squiggles(got, hand, out.layout_boxes)
        truth = {
            _norm_key(k): _norm_val(v)
            # a pair whose element render_spec skipped (off-page) is
            # unreadable by ANY OCR — excluding it keeps the e2e metric
            # about the engine, not the synth layout's overflow
            for i, (k, v, _) in enumerate(spec.pairs)
            if v.strip() and i not in spec.dropped_pair_ids
        }
        a, b, c = _exact_counts(got, truth)
        tp, fp, fn = tp + a, fp + b, fn + c

        def _near(a: str, b: str) -> bool:
            return cer(a, b) <= 0.25

        matched_g = set()
        for k, v in truth.items():
            hit = None
            for gk, gv in got.items():
                if gk in matched_g:
                    continue
                if _near(k, gk) and _near(v, gv):
                    hit = gk
                    break
            if hit is not None:
                matched_g.add(hit)
                rtp += 1
            else:
                rfn += 1
        rfp += len(got) - len(matched_g)

    return {
        "n_docs": n_docs,
        "exact": _prf(tp, fp, fn),
        "relaxed_cer_0.25": _prf(rtp, rfp, rfn),
    }


def evaluate_signature_detection(
    engine, n_docs: int = 10, page_size: int = 960, seed: int = 24601
) -> dict:
    """E2E signature capability (BASELINE config 4): render forms whose
    signature values are pen squiggles, run the FULL engine, and measure
    (a) a handwriting box overlapping the truth squiggle region,
    (b) the squiggle surfacing as a signature field via label pairing
        (engine/handwriting.handwriting_to_fields — the orchestrator path).
    The reference gets this from Gemini seeing the page pixels."""
    gen = SF.FormGenerator(seed=seed)
    found_box = found_field = total = 0
    while total < n_docs:
        spec = gen.generate(page_size)
        sig = [
            e for e in spec.elements
            if e.role == "value" and e.field_type == "signature"
        ]
        if not sig:
            continue
        total += 1
        page = SF.render_spec(spec, augment=False)
        pixels = (page.image * 255).astype(np.uint8)
        out = engine.process_pages([PageImage(pixels, 1)])[0]
        hand = [
            b for b in out.layout_boxes if b.get("type") == "handwriting"
        ]
        e = sig[0]
        hit = None
        for hb in hand:
            hx = hb["polygon"][0::2]
            hy = hb["polygon"][1::2]
            if (min(hx) < e.x1 and max(hx) > e.x0
                    and min(hy) < e.y1 and max(hy) > e.y0):
                hit = hb
                break
        if hit is not None:
            found_box += 1
            fields = handwriting_to_fields(hand, out.layout_boxes)
            if any(f["field_value"] == "signed" for f in fields):
                found_field += 1
    return {
        "n_docs": total,
        "handwriting_box_rate": round(found_box / max(total, 1), 3),
        "signature_field_rate": round(found_field / max(total, 1), 3),
    }


def evaluate_field_extraction(
    extractor, n_docs: int = 20, seed: int = 7777
) -> FieldEvalResult:
    """Generate synthetic 'Key: Value' documents, extract, score exact-match
    (key, value) pair F1 — the reference's Gemini quality metric analog."""
    rng = random.Random(seed)
    keys = ["Name", "Date", "Email", "Phone", "Total Amount", "Address",
            "Invoice Number", "City", "Reference"]
    values = {
        "Name": ["John Smith", "Mary Garcia", "Wei Chen"],
        "Date": ["15/01/2024", "2024-03-02"],
        "Email": ["a@b.com", "billing@acme.com"],
        "Phone": ["(555) 123-4567", "+91 9876543210"],
        "Total Amount": ["$1,234.56", "$99"],
        "Address": ["123 Main Street, Springfield, IL"],
        "Invoice Number": ["INV-2024-001", "12345"],
        "City": ["Springfield", "Mumbai"],
        "Reference": ["REF-88", "A-12-B"],
    }
    tp = fp = fn = 0
    for _ in range(n_docs):
        chosen = rng.sample(keys, rng.randint(3, 6))
        truth = {k: rng.choice(values[k]) for k in chosen}
        text = "\n".join(f"{k}: {v}" for k, v in truth.items())
        result = extractor.extract(text)
        got = {
            f.field_key: f.field_value
            for f in result.fields
            if f.field_value
        }
        a, b, c = _exact_counts(got, truth)
        tp, fp, fn = tp + a, fp + b, fn + c
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return FieldEvalResult(
        precision=precision, recall=recall, f1=f1, n_docs=n_docs
    )
