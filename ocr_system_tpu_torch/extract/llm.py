"""Field extraction by a generative decoder (``extraction_method: "llm"``):
the local stand-in for the reference's one Gemini call per document
(gemini_service.py:235-364), which sends the document's concatenated OCR
markdown with an instruction and gets typed fields back as JSON.

``DeepSeekV2Extractor`` builds the prompt (an instruction preamble after
the reference's system prompt and ``_build_prompt``, then the markdown),
tokenizes it, generates greedily through ``models/deepseek_v2.py``
(prefill, then decode through the latent cache) exactly
``llm_max_new_tokens`` tokens, with no stop at an end token, so that the
work per document is fixed, and parses the text into an
``ExtractionResult``. Output that does not parse gives no fields and
counts ``llm.unparsed``; it never raises (the orchestrator would retry the
whole generation). The reference's re-prompt after a parse failure is not
ported.

The published tokenizer and weights are not in the repository: the
weights are seeded (``llm_weight_seed``) and the tokenizer is a stand-in
(``StandInTokenizer``), so the fields mean nothing until the real files
are read; the work per token is the model's.

Spans and counters (``utils/profiler``): ``llm.generate`` around each
document (counters ``llm.prompt_tokens``, ``llm.new_tokens``,
``llm.unparsed``) over ``llm.prompt`` (preamble, markdown, tokenizer),
``llm.prefill`` (count ``tokens``; an ``llm.attn`` and an ``llm.moe`` span
per layer), one ``llm.decode`` around every decode step (count ``tokens``,
the steps; the graph's capture before it) with the ``device_sync`` that
reads the new ids back at its end, and ``llm.parse``.
"""

from __future__ import annotations

import json
import re
import threading
import time
import zlib

import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import resolve_device
from ocr_system_tpu_torch.extract.rules import infer_language
from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.models.deepseek_v2 import PRESETS, DeepSeekV2, GreedyDecoder
from ocr_system_tpu_torch.utils.profiler import count, span

FIELD_TYPES = ("text", "number", "date", "email", "phone", "currency", "address", "name",
               "checkbox", "signature")

PREAMBLE = """You are a document data extraction system. Read the OCR text of the document \
below and extract every field, that is every key with its value, as JSON.

Return only one JSON object of this shape:
{"fields": [{"field_key": "<the document's own label>", "field_value": "<the value as \
written>", "field_type": "<one of: """ + ", ".join(FIELD_TYPES) + """>", "confidence": \
<0.0 to 1.0>}], "form_type": "<the kind of document>", "language": "<en or hi>"}

Confidence:
- 0.95 to 1.0: the value is printed clearly and its label is explicit.
- 0.80 to 0.94: small OCR noise, or a label that is implied.
- 0.60 to 0.79: the value is ambiguous or partly illegible.
- below 0.60: the value is a guess.

Keep the document's order and its own labels. Leave out a label with no value. \
A checked box is the value "checked".
"""


class StandInTokenizer:
    """A stand-in for the published tokenizer: the text split into pieces
    (a word, a run of at most 3 digits or one other character, each with
    the space before it; or a run of other white space), each piece hashed
    into the ids after the special ones; about one id a word. It keeps the
    piece of each id it has made, for decoding (an id it never made
    decodes to nothing)."""

    PAD, BOS, EOS = 0, 1, 2
    SPECIAL = 3
    PIECES = re.compile(r" ?[^\W\d_]+| ?\d{1,3}| ?\S|\s+")

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.pieces: dict[int, str] = {}

    def piece_id(self, piece: str) -> int:
        return self.SPECIAL + zlib.crc32(piece.encode()) % (self.vocab_size - self.SPECIAL)

    def encode(self, text: str) -> list[int]:
        ids = [self.BOS]
        for piece in self.PIECES.findall(text):
            i = self.piece_id(piece)
            self.pieces[i] = piece
            ids.append(i)
        return ids

    def decode(self, ids: list[int]) -> str:
        return "".join(self.pieces.get(i, "") for i in ids)


def build_prompt(ocr_text: str, template: dict | None = None,
                 custom_prompt: str | None = None) -> str:
    """The preamble, the template's expected fields and the custom
    instruction where given (the reference's ``_build_prompt``), then the
    document's markdown."""
    parts = [PREAMBLE]
    if template:
        expected = ", ".join(str(f) for f in template.get("expected_fields") or [])
        parts.append(f"This document is a {template.get('name', 'form')}."
                     + (f" Expected fields: {expected}." if expected else "") + "\n")
    if custom_prompt:
        parts.append(f"Additional instructions: {custom_prompt}\n")
    parts.append(f"OCR text:\n{ocr_text}\n\nJSON:\n")
    return "\n".join(parts)


def parse_fields(text: str) -> tuple[list[ExtractedField], str, str | None] | None:
    """The fields, form type and language of the first JSON object in
    ``text``; None where there is none or it has no list of fields."""
    start = text.find("{")
    if start < 0:
        return None
    try:
        obj, _ = json.JSONDecoder().raw_decode(text[start:])
    except ValueError:
        return None
    if not isinstance(obj, dict) or not isinstance(obj.get("fields"), list):
        return None
    fields = []
    for f in obj["fields"]:
        if not isinstance(f, dict) or not str(f.get("field_key") or "").strip():
            continue
        ftype = str(f.get("field_type") or "text")
        try:
            conf = min(max(float(f.get("confidence", 0.85)), 0.0), 1.0)
        except (TypeError, ValueError):
            conf = 0.85
        fields.append(ExtractedField(str(f["field_key"]).strip(),
                                     str(f.get("field_value") or "").strip(),
                                     ftype if ftype in FIELD_TYPES else "text", conf))
    language = obj.get("language")
    return fields, str(obj.get("form_type") or "Unknown"), (
        language if language in ("en", "hi") else None)


class DeepSeekV2Extractor:
    """The generative extractor on the card unless the caller asks for the
    CPU (``device``): ``settings.llm_model`` (a preset of
    ``models/deepseek_v2.py``) with seeded weights in the compute dtype."""

    name = "llm"

    def __init__(self, settings: Settings | None = None,
                 device: str | torch.device | None = None):
        self.settings = settings or get_settings()
        self.device = resolve_device(device)
        cfg = PRESETS[self.settings.llm_model]
        self.model = DeepSeekV2(cfg, self.settings.llm_weight_seed, self.device,
                                getattr(torch, self.settings.compute_dtype))
        self.tokenizer = StandInTokenizer(cfg.vocab_size)
        self.max_new_tokens = self.settings.llm_max_new_tokens
        self._lock = threading.Lock()

    @torch.inference_mode()
    def generate(self, prompt_ids: list[int]) -> list[int]:
        """Greedy decoding of exactly ``max_new_tokens`` ids after the
        prompt: the prompt's prefill, then one decode step per further id
        (``GreedyDecoder``: a CUDA graph on the card, each step fed the
        last id there), queued back to back; the ids read back once. One
        document at a time: the server extracts each upload in a thread of
        its own, and a document's latent cache and graph are its own."""
        n = self.max_new_tokens
        with self._lock:
            ids = torch.tensor(prompt_ids, dtype=torch.long).to(self.device)
            with span("llm.prefill"):
                count("tokens", len(prompt_ids))
                logits, cache = self.model.prefill(ids, len(prompt_ids) + n)
            out = torch.empty(n, dtype=torch.long, device=self.device)
            out[0] = logits.argmax()
            decoder = GreedyDecoder(self.model, cache, out[0]) if n > 1 else None
            with span("llm.decode"):
                count("tokens", n - 1)
                for t in range(1, n):
                    out[t: t + 1] = decoder.step()
                with span("device_sync"):
                    return out.tolist()

    def extract(
        self,
        ocr_text: str,
        line_confidences: dict[str, float] | None = None,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> ExtractionResult:
        t0 = time.perf_counter()
        with span("llm.generate"):
            with span("llm.prompt"):
                ids = self.tokenizer.encode(build_prompt(ocr_text, template, custom_prompt))
            count("llm.prompt_tokens", len(ids))
            new = self.generate(ids)
            count("llm.new_tokens", len(new))
            with span("llm.parse"):
                text = self.tokenizer.decode(new)
                parsed = parse_fields(text)
            if parsed is None:
                count("llm.unparsed")
        fields, form_type, language = parsed or ([], "Unknown", None)
        return ExtractionResult(
            fields=fields,
            form_type=form_type,
            language=language or infer_language(ocr_text),
            raw_response=text,
            processing_time_ms=int((time.perf_counter() - t0) * 1000),
            token_count=len(ids) + len(new),
            success=True,
            error=None if parsed is not None else "the model's output held no JSON fields",
        )
