"""Layout-model extraction serving: tokenize OCR boxes, run the transformer,
decode BIO tags into fields — with the reference's retry/parse semantics
(port of ocr_system_tpu/extract/layout_model.py).

Parity target: GeminiService.extract_from_text (gemini_service.py:235-364).
The hosted-LLM failure modes (malformed JSON, 5xx) don't exist locally, but
the *retry with degraded settings* contract survives: if a pass yields zero
fields, the service retries with a lower tagging threshold before falling
back to the rule tier (extract/rules.py) — mirroring the reference's
"rebuild prompt with previous error" loop in spirit, deterministic in
implementation.

The transformer runs on the card (``models/layout_extractor.py``, weights
``weights/extract.npz``); tokenizing, decoding and the fallback are host
code, a copy of the JAX module's.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import DTypePolicy, resolve_device
from ocr_system_tpu_torch.core.mesh import engine_mesh
from ocr_system_tpu_torch.core.weights import load_npz
from ocr_system_tpu_torch.extract.directives import (
    Directives,
    apply_directives,
    key_tag_bias,
    parse_directives,
)
from ocr_system_tpu_torch.extract.postfix import (
    FORM_KEY_LEXICON,
    autocorrect_value,
    clean_key,
    infer_family_from_keys,
    snap_key,
)
from ocr_system_tpu_torch.extract.rules import RuleExtractor, infer_language
from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.models.layers import LayerNorm
from ocr_system_tpu_torch.models.layout_extractor import (
    COORD_BUCKETS,
    FIELD_TYPES,
    FORM_TYPES,
    LayoutExtractor,
    TAGS,
)
from ocr_system_tpu_torch.parallel.ring_attention import chunked_extract_merge

# the trained extractor (checkpoints/extract, written by
# export_torch_weights.py): bf16 but LayerNorm, which the serving dtypes
# read losslessly
WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "extract.npz"

_I_O, _I_BK, _I_IK, _I_BV, _I_IV = range(5)
assert TAGS == ("O", "B-KEY", "I-KEY", "B-VAL", "I-VAL")


def tokenize_layout(
    word_boxes: list[dict],
    page_wh: tuple[float, float],
    charset,
    max_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[int]]:
    """Char-level tokens with per-char box coords.

    Each word box contributes its characters (sharing the word's quantized
    bbox) plus a trailing space token. Returns (ids, boxes, mask,
    word_of_token) padded/truncated to max_len.
    """
    w_pg, h_pg = max(page_wh[0], 1.0), max(page_wh[1], 1.0)
    ids: list[int] = []
    boxes: list[list[int]] = []
    word_of: list[int] = []
    for wi, wb in enumerate(word_boxes):
        poly = wb.get("polygon", [0] * 8)
        xs, ys = poly[0::2], poly[1::2]
        qx0 = int(min(xs) / w_pg * (COORD_BUCKETS - 1))
        qy0 = int(min(ys) / h_pg * (COORD_BUCKETS - 1))
        qx1 = int(max(xs) / w_pg * (COORD_BUCKETS - 1))
        qy1 = int(max(ys) / h_pg * (COORD_BUCKETS - 1))
        q = [
            max(0, min(qx0, COORD_BUCKETS - 1)),
            max(0, min(qy0, COORD_BUCKETS - 1)),
            max(0, min(qx1, COORD_BUCKETS - 1)),
            max(0, min(qy1, COORD_BUCKETS - 1)),
        ]
        text = (wb.get("content") or "") + " "
        for ch in text:
            cid = charset.char_to_id(ch)
            ids.append(cid)
            boxes.append(q)
            word_of.append(wi)
        if len(ids) >= max_len:
            break
    n = min(len(ids), max_len)
    out_ids = np.zeros((max_len,), np.int32)
    out_boxes = np.zeros((max_len, 4), np.int32)
    out_mask = np.zeros((max_len,), np.int32)
    if n:
        out_ids[:n] = ids[:n]
        out_boxes[:n] = np.asarray(boxes[:n], np.int32)
        out_mask[:n] = 1
    return out_ids, out_boxes, out_mask, word_of[:n]


def _span_pair_cost(kb: np.ndarray, vb: np.ndarray) -> float:
    """Geometric cost of pairing a key span box with a value span box (both
    [x0, y0, x1, y1] in quantized page coords). Real form geometries:
    same box (inline 'Key: Value'), key left of value on the same row, or
    key directly above the value."""
    ky = (kb[1] + kb[3]) / 2.0
    vy = (vb[1] + vb[3]) / 2.0
    kh = max(kb[3] - kb[1], 1.0)
    vh = max(vb[3] - vb[1], 1.0)
    if np.allclose(kb, vb):
        return 0.0  # inline: shared element box
    same_row = abs(ky - vy) < 0.7 * max(kh, vh)
    if same_row and kb[2] <= vb[0] + 0.5 * kh:
        return max(float(vb[0] - kb[2]), 0.0)  # horizontal gap
    x_overlap = min(kb[2], vb[2]) - max(kb[0], vb[0])
    if x_overlap > 0 and kb[3] <= vb[1] + 0.5 * vh:
        gap = max(float(vb[1] - kb[3]), 0.0)
        # below-pair base penalty ~ one label height in quantized units:
        # the old +1.0 let 'key above-left' (46) beat a same-row value 53
        # units to the right (diag r4 doc 7: 'Ciase' stole the next row's
        # address while 'required' sat beside it) — same-row is the
        # canonical form layout and must win unless it is genuinely far
        return 1.5 * gap + 0.2 * abs(float(kb[0] - vb[0])) + 25.0
    return float("inf")


def element_vote(
    tag_logp: np.ndarray,
    tag_ids: np.ndarray,
    word_of: list[int],
    n_valid: int,
    tokens_text: str,
) -> np.ndarray:
    """Sub-word-consistent tag refinement (decode-time, model unchanged).

    Char-level argmax tags churn INSIDE a word on out-of-family forms
    ('Organisation' tagged Kvvvkvvvvvkkk char by char) — but a word is one
    unit of meaning. Pool the tag log-probs over each space-delimited
    sub-word WITHIN each det box and rewrite its chars to the pooled kind.
    Pooling per sub-word (not per whole box) matters because the real det
    stage emits row-level boxes spanning several fields ('Name: Nina
    Smith  Date: May 8' is ONE box) — whole-box pooling would collapse a
    K V K V row to a single kind, sub-word pooling preserves the
    alternation. A separator space between two same-kind sub-words takes
    the continuation tag so the span survives decode intact.
    Parity bar: Gemini reads whole words (gemini_service.py:235-364)."""
    out = np.array(tag_ids, copy=True)
    if not len(word_of):
        return out
    n = min(n_valid, len(word_of), len(tokens_text))
    a = 0
    while a < n:
        b = a
        while b < n and word_of[b] == word_of[a]:
            b += 1
        # sub-words: maximal non-space runs within [a, b)
        segs: list[tuple[int, int]] = []
        i = a
        while i < b:
            if tokens_text[i] == " ":
                i += 1
                continue
            j = i
            while j < b and tokens_text[j] != " ":
                j += 1
            segs.append((i, j))
            i = j
        prev_kind = 0
        prev_end = a
        for (i, j) in segs:
            lp = tag_logp[i:j]
            score_o = float(lp[:, _I_O].sum())
            score_k = float(np.logaddexp(lp[:, _I_BK], lp[:, _I_IK]).sum())
            score_v = float(np.logaddexp(lp[:, _I_BV], lp[:, _I_IV]).sum())
            kind = int(np.argmax([score_o, score_k, score_v]))
            if kind == 0:
                out[i:j] = _I_O
            elif kind == 1:
                out[i:j] = _I_IK
                out[i] = _I_IK if prev_kind == 1 else _I_BK
            else:
                out[i:j] = _I_IV
                out[i] = _I_IV if prev_kind == 2 else _I_BV
            # separator spaces continue a same-kind span across sub-words
            if prev_kind == kind and kind != 0:
                cont = _I_IK if kind == 1 else _I_IV
                out[prev_end:i] = cont
            else:
                out[prev_end:i] = _I_O
            prev_kind, prev_end = kind, j
        if prev_end < b:
            out[prev_end:b] = _I_O
        a = b
    return out


def force_inline_split(
    tag_ids: np.ndarray,
    word_of: list[int],
    tokens_text: str,
    n_valid: int,
) -> np.ndarray:
    """Decode assist for boxes the model cannot read.

    Round-3 checkpoints trained on Latin forms only, leaving Devanagari
    char embeddings random; the model tagged a Hindi inline row like
    'कुल: राखा' as one single-kind span — the key swallowed its value and
    pairing shifted down the page. The r4 2x checkpoint restores deva to
    training (15%), but the structural split stays: it is measured-safe
    and covers rec noise the model has still never seen. The
    training data labels inline rows as key-incl-colon + value
    (synth_forms emit_span), so apply that same split structurally when
    (a) the box is mostly Devanagari (outside the training distribution),
    (b) it contains an inline colon with a key-shaped left side, and
    (c) the model produced NO split (single-kind tags). A model that
    learns Devanagari later will split these itself, making (c) false and
    this a no-op."""
    a = 0
    while a < n_valid:
        b = a
        while b < n_valid and word_of[b] == word_of[a]:
            b += 1
        txt = tokens_text[a:b]
        if ":" in txt:
            p = a + txt.index(":")
            left = txt[: p - a].strip()
            right = txt[p - a + 1:].strip()
            # gate on the KEY side: that's the part the model must read to
            # place the split, and Hindi values are often pure ASCII
            # ('तोनीह:2009-04-15' is < 40% deva overall but its key is 100%)
            left_core = [c for c in left if c != " "]
            deva = [c for c in left_core if "ऀ" <= c <= "ॿ"]
            kinds = {int(t) for t in tag_ids[a:b]}
            kinds.discard(_I_O)
            single = (kinds <= {_I_BK, _I_IK}) or (kinds <= {_I_BV, _I_IV})
            key_shaped = len(deva) >= 2 and len(deva) >= 0.5 * len(left_core)
            if left and right and key_shaped and single:
                tag_ids[a: p + 1] = _I_IK
                tag_ids[a] = _I_BK
                q = p + 1
                while q < b and tokens_text[q] == " ":
                    tag_ids[q] = _I_O
                    q += 1
                if q < b:
                    tag_ids[q:b] = _I_IV
                    tag_ids[q] = _I_BV
        a = b
    return tag_ids


def decode_tags(
    tag_ids: np.ndarray,
    type_ids: np.ndarray,
    conf: np.ndarray,
    tokens_text: str,
    boxes: np.ndarray,
    n_valid: int,
) -> list[ExtractedField]:
    """BIO spans -> (key, value) fields.

    Values pair with keys GEOMETRICALLY (same element box, left-of on the
    same row, or directly above) rather than by token adjacency — two-column
    forms interleave key/value spans in reading order, so adjacency pairing
    crosses columns. Orphan values become fields with empty keys."""
    # BIO repair: an I-tag without a live span of its kind starts one
    # (standard conlleval-style fixup) — without it a model that misses
    # just the B token drops the whole span, and on out-of-family forms
    # that single-token brittleness was a measured F1 cliff
    tag_ids = np.array(tag_ids, copy=True)
    for i in range(n_valid):
        t = tag_ids[i]
        if t == _I_IK and (i == 0 or tag_ids[i - 1] not in (_I_BK, _I_IK)):
            tag_ids[i] = _I_BK
        elif t == _I_IV and (i == 0 or tag_ids[i - 1] not in (_I_BV, _I_IV)):
            tag_ids[i] = _I_BV
    raw: list[tuple[str, int, int]] = []  # (kind, tok_start, tok_end)
    i = 0
    while i < n_valid:
        t = tag_ids[i]
        if t in (_I_BK, _I_BV):
            kind = "key" if t == _I_BK else "value"
            cont = _I_IK if t == _I_BK else _I_IV
            j = i + 1
            while j < n_valid and tag_ids[j] == cont:
                j += 1
            if tokens_text[i:j].strip():
                raw.append((kind, i, j))
            i = j
        else:
            i += 1

    # geometric span merge: on out-of-family forms the model re-emits B
    # mid-span ("organisati"+"n", "trip"+"end" as two keys), and every
    # fragment becomes a wrong field. Two ADJACENT same-kind spans with
    # only whitespace between them, on the same text row, with a small
    # horizontal gap are one span. Distinct fields survive: 3-col key rows
    # sit a column pitch apart (gap ≫ 2.2×height), stacked fields are on
    # different rows, and a key/value pair differs in kind.
    def _tok_box(a: int, b: int) -> np.ndarray:
        return np.array(
            [boxes[a:b, 0].min(), boxes[a:b, 1].min(),
             boxes[a:b, 2].max(), boxes[a:b, 3].max()], np.float32,
        )

    merged: list[tuple[str, int, int]] = []
    for kind, a, b in raw:
        if merged:
            pkind, pa, pb = merged[-1]
            if pkind == kind and not tokens_text[pb:a].strip():
                bx_p, bx_n = _tok_box(pa, pb), _tok_box(a, b)
                h = max(bx_p[3] - bx_p[1], bx_n[3] - bx_n[1], 1.0)
                same_row = abs(
                    (bx_p[1] + bx_p[3]) / 2 - (bx_n[1] + bx_n[3]) / 2
                ) < 0.7 * h
                gap = float(bx_n[0] - bx_p[2])
                # negative gap is ambiguous: fragments of the SAME word box
                # share coords (x-overlap ~ full width, merge), but a span
                # whose next piece sits far LEFT of the previous one is a
                # COLUMN WRAP — two different fields' values glued across
                # the key between them ('PO Number' stealing '286.90 USD'
                # from 'Total' on seed 5251 doc 3). Only real x-overlap
                # earns the same-box merge.
                x_overlap = float(
                    min(bx_p[2], bx_n[2]) - max(bx_p[0], bx_n[0]))
                w_min = max(1.0, min(bx_p[2] - bx_p[0], bx_n[2] - bx_n[0]))
                same_box = x_overlap > 0.8 * w_min
                if same_row and (same_box or -0.1 * h <= gap <= 2.2 * h):
                    merged[-1] = (kind, pa, b)
                    continue
        merged.append((kind, a, b))

    # span-level inline split: force_inline_split works per WORD BOX, but a
    # det row-merge can deliver 'जेखा:' 'बुमे' 'ताजे' as separate boxes that
    # all pool to KEY and geometric-merge into one key span — the span then
    # swallows its own value and steals the NEXT field's value in the greedy
    # assignment (measured: the dominant deva-slice forms_e2e loss). Same
    # deva gate as force_inline_split: the trained model is authoritative on
    # Latin, so only out-of-distribution keys are split structurally.
    def _deva_key_colon(txt: str, start: int, colon: int) -> bool:
        core = [c for c in txt[start:colon] if c != " "]
        deva = [c for c in core if "ऀ" <= c <= "ॿ"]
        return len(deva) >= 2 and len(deva) >= 0.5 * max(len(core), 1)

    def _latin_label_start(txt: str, v0: int, p2: int) -> int | None:
        """Longest run of alphabetic words (len>=2) ending at colon p2 —
        a plausible multi-word Latin label ('tozoler per povisna:'). None
        when the token touching the colon isn't a clean word (a '12:30'
        time or 'user@host:' value must not split)."""
        j = p2
        start = None
        while j > v0:
            k = txt.rfind(" ", v0, j)
            tok = txt[k + 1:j].strip()
            if not (tok.isalpha() and len(tok) >= 2):
                break
            start = k + 1 if k >= v0 else v0
            j = k
            while j > v0 and txt[j - 1] == " ":
                j -= 1
        return start

    split_spans: list[tuple[str, int, int]] = []
    for kind, a, b in merged:
        txt = tokens_text[a:b]
        p = txt.find(":")
        # Latin spans split ONLY on the multi-colon row-merge signature
        # (>=2 label colons in one key span — diag doc-15 family: det glues
        # 'K1: V1 K2: V2' into one span and both fields die); a single-colon
        # Latin span stays with the trained model (round-3 measured: the
        # model is authoritative on in-distribution Latin).
        multi_latin = kind == "key" and txt.count(":") >= 2
        if not (kind == "key" and 0 < p < len(txt) - 1
                and txt[p + 1:].strip()
                and (_deva_key_colon(txt, 0, p) or multi_latin)):
            split_spans.append((kind, a, b))
            continue
        # LOOPED split (ADVICE r3): a det row-merge can pool SEVERAL inline
        # fields ('क: 1 ख: 2') into one key span; splitting only at the
        # first colon leaves the second field's key inside the first value.
        # After each key:value cut, scan the remainder for another label
        # ending in ':' — deva-majority token, or (multi-colon spans) a run
        # of alphabetic words — that label starts the next key.
        while True:
            split_spans.append(("key", a, a + p + 1))
            v0 = p + 1
            while v0 < len(txt) and txt[v0] == " ":
                v0 += 1
            nxt = None
            i = v0
            while nxt is None:
                p2 = txt.find(":", i)
                if p2 < 0 or not txt[p2 + 1:].strip():
                    break
                s2 = p2
                while s2 > v0 and txt[s2 - 1] != " ":
                    s2 -= 1
                if s2 > v0 and _deva_key_colon(txt, s2, p2):
                    nxt = (s2, p2)
                elif multi_latin:
                    s2l = _latin_label_start(txt, v0, p2)
                    if s2l is not None and s2l > v0:
                        nxt = (s2l, p2)
                i = p2 + 1
            if nxt is None:
                if txt[v0:].strip():
                    split_spans.append(("value", a + v0, b))
                break
            s2, p2 = nxt
            if txt[v0:s2].strip():
                split_spans.append(("value", a + v0, a + s2))
            a, p, txt = a + s2, p2 - s2, txt[s2:]
    merged = split_spans

    spans: list[tuple[str, str, float, str, np.ndarray]] = []
    for kind, i, j in merged:
        text = tokens_text[i:j].strip()
        span_conf = float(np.mean(conf[i:j])) if j > i else 0.0
        types, counts = np.unique(type_ids[i:j], return_counts=True)
        ftype = FIELD_TYPES[int(types[np.argmax(counts)])]
        spans.append((kind, text, span_conf, ftype, _tok_box(i, j)))

    keys = [s for s in spans if s[0] == "key"]
    values = [s for s in spans if s[0] == "value"]

    # greedy min-cost assignment (few spans per page; O(K*V) is fine)
    costs = [
        (_span_pair_cost(k[4], v[4]), ki, vi)
        for ki, k in enumerate(keys)
        for vi, v in enumerate(values)
    ]
    costs.sort(key=lambda c: c[0])
    key_of_value: dict[int, int] = {}
    used_keys: set[int] = set()
    for cost, ki, vi in costs:
        if cost == float("inf"):
            break
        if ki in used_keys or vi in key_of_value:
            continue
        key_of_value[vi] = ki
        used_keys.add(ki)

    fields: list[ExtractedField] = []
    for vi, (_, text, c, ftype, _vb) in enumerate(values):
        ki = key_of_value.get(vi)
        if ki is not None:
            _, ktext, kc, _, _ = keys[ki]
            fields.append(
                ExtractedField(
                    field_key=clean_key(ktext),
                    field_value=autocorrect_value(text, ftype),
                    field_type=ftype,
                    confidence=round(min(kc, c), 4),
                )
            )
        else:
            fields.append(
                ExtractedField(
                    field_key="",
                    field_value=autocorrect_value(text, ftype),
                    field_type=ftype,
                    confidence=round(c, 4),
                )
            )
    # 1-char alphabetic keys are tag noise, not form labels — they pair
    # with real values and cost held-out precision (measured 0.26 -> 0.31
    # at equal recall when dropped)
    return [
        f for f in fields
        if not (len(f.field_key) == 1 and f.field_key.isalpha())
    ]


class LayoutModelExtractor:
    """Serves LayoutExtractor for structured extraction, on the card unless
    the caller asks for the CPU (``device``). Weights: ``state_dict`` if
    given, else the ``.npz`` at ``settings.extract_checkpoint``, else
    ``WEIGHTS``; a missing file raises."""

    name = "layout_model"

    def __init__(
        self,
        settings: Settings | None = None,
        state_dict: dict[str, torch.Tensor] | None = None,
        device: str | torch.device | None = None,
    ):
        self.settings = settings or get_settings()
        self.device = resolve_device(device)
        self.charset = get_charset("multilingual")
        self.dtype = DTypePolicy.from_names(
            self.settings.compute_dtype, self.settings.param_dtype
        ).compute_dtype
        self.max_len = 2048
        # an sp mesh axis > 1 -> serve with in-model ring attention (the
        # sequence shards over the ring; the power-of-two token buckets
        # divide over it)
        mesh = engine_mesh(self.device)
        self.model = LayoutExtractor(
            vocab_size=self.charset.size,
            dim=self.settings.extract_dim,
            depth=self.settings.extract_depth,
            max_len=self.max_len,
            sequence_parallel=mesh is not None and mesh.shape.get("sp", 1) > 1,
        )
        if state_dict is None:
            path = Path(self.settings.extract_checkpoint or WEIGHTS)
            if not path.is_file():
                raise FileNotFoundError(
                    f"layout extractor weights {path} not found (written by "
                    "export_torch_weights.py)"
                )
            state_dict = load_npz(path)
        self.model.load_state_dict(state_dict)
        # flax casts every parameter but LayerNorm's to the compute dtype at
        # each use; one cast here gives the same values
        for mod in self.model.modules():
            if not isinstance(mod, LayerNorm):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(self.dtype)
        self.model.to(self.device).eval()
        self._fallback = RuleExtractor()

    @torch.inference_mode()
    def forward(self, ids: np.ndarray, boxes: np.ndarray, mask: np.ndarray) -> dict:
        """One window through the transformer on the extractor's device:
        (L,) ids, (L, 4) boxes, (L,) mask -> the model's outputs for it, on
        the host as float32 numpy arrays without the batch axis."""
        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(
                self.device, torch.long)

        out = self.model(dev(ids), dev(boxes), dev(mask), self.dtype)
        return {k: v[0].cpu().numpy() for k, v in out.items()}

    def extract_from_layout(
        self,
        word_boxes: list[dict],
        page_wh: tuple[float, float],
        ocr_text: str = "",
        line_confidences: dict | None = None,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> ExtractionResult:
        # READING-ORDER sort (train/serve skew fix): training streams are
        # row-clustered reading order (synth_forms._reading_order), but the
        # engine delivers word boxes in rec-dispatch order — scrambled
        # sequences put decode adjacency logic out of spec (measured: the
        # geometric span merge glued 'Fuii Name' + 'Signature:' — same row,
        # NEGATIVE gap because the stream ran right-to-left — into one key,
        # orphaning the signature value; seed-5251 doc 6). Same sort key as
        # training so the model sees its training distribution.
        def _ro_key(b):
            poly = b.get("polygon") or [0] * 8
            # page FIRST: multi-page streams must not interleave rows of
            # different pages that share y ranges (every page starts at
            # y~0 — an unpaged sort shuffled 24 pages into 'Invoice
            # Invoice Invoice ... INV-0002 INV-0003 ...')
            return (
                b.get("page_number", 1),
                round(min(poly[1::2]) / 14),
                min(poly[0::2]),
            )

        word_boxes = sorted(word_boxes, key=_ro_key)
        # long documents: more tokens than max_len -> page-chunk map-reduce
        # (SURVEY §5.7 pragmatic tier; ring attention serves the in-model
        # path when an sp mesh axis is available). Multi-PAGE streams always
        # chunk (per page): pages share the same coordinate space, so one
        # window over two pages lets the model pair a key on page 1 with a
        # value sitting at the "same" spot on page 2 — and training only
        # ever shows single pages.
        approx_tokens = sum(len(b.get("content") or "") + 1 for b in word_boxes)
        n_pages = len({b.get("page_number", 1) for b in word_boxes})
        if (approx_tokens > self.max_len or n_pages > 1) and len(word_boxes) > 1:
            result = self._extract_chunked(
                word_boxes, page_wh, ocr_text, line_confidences, template,
                custom_prompt,
            )
        else:
            result = self._extract_direct(
                word_boxes, page_wh, ocr_text, line_confidences, template,
                custom_prompt,
            )
        # field-level directive steering applies ONCE at the top (never per
        # chunk: an empty missing-field placeholder added inside chunk 1
        # would win the earlier-chunk-wins merge over chunk 2's real value)
        directives = parse_directives(custom_prompt, template)
        if directives is not None:
            result.fields = apply_directives(result.fields, directives)
        return result

    def _extract_direct(
        self,
        word_boxes: list[dict],
        page_wh: tuple[float, float],
        ocr_text: str = "",
        line_confidences: dict | None = None,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> ExtractionResult:
        """Single-window extraction; tokenize_layout truncates at max_len,
        so this always terminates (the chunked path calls it per chunk — a
        pathological chunk that can't shrink, e.g. one giant box, degrades
        to truncation instead of recursing)."""
        t0 = time.perf_counter()
        ids, boxes, mask, word_of = tokenize_layout(
            word_boxes, page_wh, self.charset, self.max_len
        )
        n_valid = int(mask.sum())
        if n_valid == 0:
            return ExtractionResult(
                fields=[], success=True,
                processing_time_ms=int((time.perf_counter() - t0) * 1000),
            )
        # length buckets: pad to the smallest power-of-two window instead of
        # always max_len — attention is O(L^2), so a typical 1-page form
        # (300-800 tokens) costs 1/16th of the full 2048 window (and the
        # JAX package compiles each bucket once)
        bucket = 256
        while bucket < n_valid:
            bucket *= 2
        bucket = min(bucket, self.max_len)
        out = self.forward(ids[:bucket], boxes[:bucket], mask[:bucket])
        # first-index argmax on the host, as jnp.argmax
        tag_ids = np.argmax(out["tag_logits"], -1)
        tag_logp = torch.log_softmax(torch.from_numpy(out["tag_logits"]), -1).numpy()
        type_ids = np.argmax(out["type_logits"], -1)
        conf = out["confidence"]
        form_idx = int(np.argmax(out["form_logits"]))
        # positional decode: unknown ids become spaces (charset.decode drops
        # them, which would misalign span indices into tokens_text)
        tokens_text = "".join(
            self.charset.id_to_char(int(i)) or " " for i in ids[:n_valid]
        )
        # custom_prompt / FormTemplate steering (ref gemini_service.py:
        # 511-549 — the prompt actually changes what the LLM extracts;
        # extract/directives.py is the deterministic analog): KEY-tag
        # log-prob bonus on expected-field name spans BEFORE the sub-word
        # vote, field-level snapping/filtering after decode.
        directives = parse_directives(custom_prompt, template)
        if directives is not None and directives.expected:
            tag_logp = np.array(tag_logp)
            key_tag_bias(tag_logp, tokens_text, directives)
            tag_ids = np.argmax(tag_logp, -1)
        tag_ids = element_vote(
            tag_logp, tag_ids, word_of, n_valid, tokens_text
        )
        tag_ids = force_inline_split(tag_ids, word_of, tokens_text, n_valid)

        fields = decode_tags(tag_ids, type_ids, conf, tokens_text, boxes, n_valid)

        # retry-then-fallback contract (see module docstring): an untrained /
        # unconfident model yields nothing usable -> rule tier guarantees
        # output. "Nothing usable" = no fields, or only orphan values (every
        # key empty — what random-init tags decode to after BIO repair);
        # orphan-only output survives only if rules also find nothing keyed.
        attempts = 1
        retried = False
        degenerate = not fields or all(not f.field_key for f in fields)
        if degenerate and attempts < self.settings.extraction_max_retries:
            # ADAPTIVE RETRY (reference gemini_service.py:443-484: rebuild
            # the prompt with the parse failure + expected JSON shape and
            # re-ask). The deterministic analog: re-DECODE the same logits
            # with the known form vocabulary as a KEY-tag prior — the
            # failure evidence ("no keyed spans decoded") selects the
            # retry strategy, and the bias only resolves spans the model
            # already found ambiguous. No second forward pass needed.
            attempts += 1
            retried = True

            union = Directives(expected=[
                (k, "text") for lex in FORM_KEY_LEXICON.values() for k in lex
            ])
            retry_logp = np.array(tag_logp)
            key_tag_bias(retry_logp, tokens_text, union)
            retry_ids = element_vote(
                retry_logp, np.argmax(retry_logp, -1), word_of, n_valid,
                tokens_text,
            )
            retry_ids = force_inline_split(
                retry_ids, word_of, tokens_text, n_valid
            )
            retry_fields = decode_tags(
                retry_ids, type_ids, conf, tokens_text, boxes, n_valid
            )
            # accept the retry only when it recovers a COMPLETE pair —
            # keyed-but-valueless spans must still fall through to the
            # rules tier (which reads inline 'Key: value' rows directly)
            if any(f.field_key and f.field_value for f in retry_fields):
                fields = retry_fields
                degenerate = False
        if degenerate and attempts < self.settings.extraction_max_retries + 1:
            result = self._fallback.extract(
                ocr_text, line_confidences, template, custom_prompt
            )
            if not fields or any(f.field_key for f in result.fields):
                result.token_count = n_valid
                result.raw_response = "layout_model:degenerate->rules"
                return result

        # known form family: snap noisy keys onto its canonical lexicon
        # (the local analog of template.expected_fields sent to Gemini;
        # Unknown forms have no lexicon and keep the OCR reading). The
        # model head's family prediction can miss on noisy pages — a
        # key-evidence vote rescues it when the decoded keys themselves
        # near-match one family's lexicon (measured: seed-5251 doc 4, a
        # Medical Form predicted Unknown left 'aliergies' unsnapped).
        form_type = infer_family_from_keys(
            [f.field_key for f in fields], FORM_TYPES[form_idx]
        )
        lex = FORM_KEY_LEXICON.get(form_type)
        if lex:
            for f in fields:
                if f.field_key:
                    f.field_key = snap_key(f.field_key, lex)

        return ExtractionResult(
            fields=fields,
            form_type=form_type,
            language=infer_language(ocr_text),
            token_count=n_valid,
            processing_time_ms=int((time.perf_counter() - t0) * 1000),
            success=True,
            raw_response=(
                "layout_model:retry-lexicon-bias" if retried else None
            ),
        )

    def _extract_chunked(
        self, word_boxes, page_wh, ocr_text, line_confidences, template,
        custom_prompt,
    ) -> ExtractionResult:
        """Split word boxes by page into overlapping chunks that fit
        max_len, extract each, merge with earlier-chunk-wins dedup. The
        overlap exists for exactly one failure mode: a key whose value lands
        in the NEXT chunk would silently lose the pair — repeating the tail
        of each chunk at the head of the next lets the pair form there, and
        the key-level dedup in chunked_extract_merge drops the duplicate."""
        chunks = split_word_boxes(
            word_boxes, self.max_len, overlap_tokens=self.max_len // 8
        )
        results = [
            self._extract_direct(
                chunk, page_wh, ocr_text="", line_confidences=line_confidences,
                template=None, custom_prompt=custom_prompt,
            )
            for chunk in chunks
        ]
        merged = chunked_extract_merge(results)
        merged.language = infer_language(ocr_text)
        # template/custom_prompt steering happens in extract_from_layout
        # (once, on the merged result — see the per-chunk poisoning note)
        return merged


def split_word_boxes(
    word_boxes: list[dict], max_len: int, overlap_tokens: int = 0
) -> list[list[dict]]:
    """Page-ordered chunking by token budget with tail overlap (see
    _extract_chunked). Pure function so the boundary behavior is testable
    without a model: any (key, value) pair of boxes within overlap_tokens of
    each other co-occurs in at least one chunk."""
    by_page: dict[int, list[dict]] = {}
    for b in word_boxes:
        by_page.setdefault(b.get("page_number", 1), []).append(b)

    def tokens(b) -> int:
        return len(b.get("content") or "") + 1

    chunks: list[list[dict]] = []
    cur: list[dict] = []
    cur_tokens = 0

    def flush(carry_overlap: bool):
        nonlocal cur, cur_tokens
        if not cur:
            return
        chunks.append(cur)
        tail: list[dict] = []
        if carry_overlap and overlap_tokens > 0:
            t = 0
            for b in reversed(cur):
                t += tokens(b)
                if t > overlap_tokens:
                    break
                tail.append(b)
            tail.reverse()
        cur = list(tail)
        cur_tokens = sum(tokens(b) for b in cur)

    for page_no in sorted(by_page):
        # windows never span pages: pages share one coordinate space, so a
        # cross-page window would collide geometry (and no true key/value
        # pair ever straddles a page — the overlap carry is intra-page only)
        flush(carry_overlap=False)
        for b in by_page[page_no]:
            n = tokens(b)
            if cur and cur_tokens + n > max_len:
                flush(carry_overlap=True)
            cur.append(b)
            cur_tokens += n
    flush(carry_overlap=False)
    return chunks


def get_extractor(settings: Settings | None = None,
                  device: str | torch.device | None = None):
    """Extraction-method dispatch (reference: config-driven engine select).

    'auto' (the default) serves the trained layout model when its weights
    (``settings.extract_checkpoint``, else ``WEIGHTS``) exist and falls back
    to the rule tier otherwise, as the JAX package does with its orbax
    checkpoint. 'layout_model' without its weights raises. 'llm' (the
    port's own) serves the generative extractor of ``extract/llm.py``,
    imported only then."""
    s = settings or get_settings()
    method = s.extraction_method
    if method == "auto":
        ckpt = s.extract_checkpoint or str(WEIGHTS)
        if Path(ckpt).is_file():
            if s.extract_checkpoint != ckpt:
                s = s.model_copy(update={"extract_checkpoint": ckpt})
            method = "layout_model"
        else:
            method = "rules"
    if method == "layout_model":
        return LayoutModelExtractor(s, device=device)
    if method == "llm":
        from ocr_system_tpu_torch.extract.llm import DeepSeekV2Extractor

        return DeepSeekV2Extractor(s, device=device)
    return RuleExtractor()
