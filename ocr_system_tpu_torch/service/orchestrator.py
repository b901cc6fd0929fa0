"""Extraction orchestration: the extract, save and validate stages of the
JAX package's workflow on one OCR result (port of
ocr_system_tpu/service/orchestrator.py, its stage logic).

- extract: the extractor on the document's word boxes (or its markdown,
  for an extractor without ``extract_from_layout``), with retries, then the
  engine's tables, selection marks and handwriting merged in as table,
  checkbox and signature fields, each merge guarded so that its failure
  costs only its own fields;
- save: each field paired with the key and value boxes of the layout
  (``BoundingBoxMatcher.find_key_value_pair``), its confidence clamped to
  [0, 1], as the rows the JAX package writes to its database;
- validate: ``ValidationService.validate_fields`` over those rows.

``fields_for`` runs the three on a ``DocumentOCRResult``. The database,
the processing log, the saved page images and the stage checkpointer of
the JAX workflow are not ported yet; the validation report is keyed by row
index where the JAX package keys it by the database's field id.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.engine.handwriting import handwriting_to_fields, squiggle_overrides
from ocr_system_tpu_torch.engine.pipeline import DocumentOCRResult, get_engine
from ocr_system_tpu_torch.engine.selection_marks import marks_to_fields
from ocr_system_tpu_torch.extract.layout_model import get_extractor
from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.service.bbox_matcher import BoundingBoxMatcher
from ocr_system_tpu_torch.service.validation import (
    ExtractionValidationReport,
    ValidationService,
)

logger = logging.getLogger(__name__)


@dataclass
class RetryPolicy:
    """Reference RetryPolicy (extraction_service.py:169-183)."""

    max_attempts: int = 2
    initial_interval: float = 0.5
    backoff_factor: float = 2.0


class ExtractionOrchestrator:
    """The extraction stages of the ExtractionService facade (reference
    extraction_service.py:794-985). ``engine`` and ``extractor`` default to
    ``get_engine`` and ``get_extractor`` of ``settings`` on ``device``."""

    def __init__(
        self,
        settings: Settings | None = None,
        engine=None,
        extractor=None,
        device: str | torch.device | None = None,
    ):
        self.settings = settings or get_settings()
        self.engine = engine or get_engine(self.settings, device=device)
        self.extractor = extractor or get_extractor(self.settings, device=device)
        self.validation = ValidationService(self.settings)
        self.matcher = BoundingBoxMatcher()
        self.extract_retry = RetryPolicy(max_attempts=2)

    def _with_retry(self, fn: Callable, policy: RetryPolicy, stage: str):
        last_err: Exception | None = None
        for attempt in range(policy.max_attempts):
            try:
                return fn()
            except Exception as e:  # retry_on=Exception, like the reference
                last_err = e
                logger.warning("stage %s attempt %d failed: %s", stage, attempt + 1, e)
                if attempt + 1 < policy.max_attempts:
                    time.sleep(policy.initial_interval * policy.backoff_factor**attempt)
        raise last_err  # type: ignore[misc]

    def fields_for(
        self,
        ocr: DocumentOCRResult,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> tuple[ExtractionResult, list[dict], ExtractionValidationReport]:
        """The extract, save and validate stages on one OCR result: the
        extraction result, its field rows and their validation report."""
        result = self._stage_extract(ocr, template, custom_prompt)
        rows = self.field_rows(ocr, result)
        return result, rows, self.validate(rows)

    def _stage_extract(
        self,
        ocr: DocumentOCRResult,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> ExtractionResult:
        line_confs = {
            b["content"]: b["confidence"]
            for b in ocr.combined_layout_boxes
            if b.get("type") == "line"
        }

        def run():
            if hasattr(self.extractor, "extract_from_layout"):
                first = ocr.pages[0] if ocr.pages else None
                wh = (first.page_width, first.page_height) if first else (1.0, 1.0)
                return self.extractor.extract_from_layout(
                    [b for b in ocr.combined_layout_boxes if b["type"] == "word"],
                    wh,
                    ocr_text=ocr.combined_markdown,
                    line_confidences=line_confs,
                    template=template,
                    custom_prompt=custom_prompt,
                )
            return self.extractor.extract(
                ocr.combined_markdown,
                line_confidences=line_confs,
                template=template,
                custom_prompt=custom_prompt,
            )

        result = self._with_retry(run, self.extract_retry, "extract")
        # table structures recovered by the engine surface as table fields
        # (reference: Azure table cells flow through the Gemini path)
        try:
            existing = {f.field_key for f in result.fields}
            for i, b in enumerate(
                x for x in ocr.combined_layout_boxes if x.get("type") == "table"
            ):
                key = f"Table {i + 1}"
                if key not in existing and b.get("content"):
                    result.fields.append(
                        ExtractedField(
                            field_key=key,
                            field_value=b["content"],
                            field_type="table",
                            confidence=b.get("confidence", 0.9),
                        )
                    )
        except Exception:
            logger.exception("table field merge failed (non-fatal)")
        # selection marks (checkboxes) become checkbox fields with yes/no
        # values (reference: Azure selection_marks feed Gemini's output and
        # the checkbox validator, validation_service.py:404-425)
        try:
            marks = [
                b for b in ocr.combined_layout_boxes
                if b.get("type") == "selection_mark"
            ]
            if marks:
                existing = {f.field_key.lower() for f in result.fields}
                for cb in marks_to_fields(marks, ocr.combined_layout_boxes):
                    if cb["field_key"].lower() in existing:
                        continue
                    result.fields.append(
                        ExtractedField(
                            field_key=cb["field_key"],
                            field_value=cb["field_value"],
                            field_type="checkbox",
                            confidence=cb["confidence"],
                        )
                    )
        except Exception:
            logger.exception("selection-mark field merge failed (non-fatal)")
        # handwriting boxes + signature-keyword labels -> signature fields
        # (the reference's Gemini reads signature presence from pixels; here
        # the engine's handwriting detector does)
        try:
            hand = [
                b for b in ocr.combined_layout_boxes
                if b.get("type") == "handwriting"
            ]
            if hand:
                # a KEYWORD-labeled squiggle ('Signature:' + pen stroke)
                # OVERRIDES the extractor's pair for the same label when
                # the shared squiggle_overrides policy says so
                # (engine/handwriting.py documents the keyword/clean-text/
                # adjacency gates)
                existing = {
                    f.field_key.lower(): f
                    for f in result.fields
                    if f.field_value.strip()
                }
                all_keys = {
                    f.field_key.lower()
                    for f in result.fields
                    if f.field_key.strip()
                }
                for sf in handwriting_to_fields(hand, ocr.combined_layout_boxes):
                    cur = existing.get(sf["field_key"].lower())
                    if cur is not None and not squiggle_overrides(
                        sf, cur.field_value, float(cur.confidence or 1.0),
                        other_keys=all_keys,
                    ):
                        continue
                    result.fields = [
                        f for f in result.fields
                        if f.field_key.lower() != sf["field_key"].lower()
                    ]
                    result.fields.append(
                        ExtractedField(
                            field_key=sf["field_key"],
                            field_value=sf["field_value"],
                            field_type="signature",
                            confidence=sf["confidence"],
                        )
                    )
        except Exception:
            logger.exception("handwriting field merge failed (non-fatal)")
        return result

    def field_rows(self, ocr: DocumentOCRResult, result: ExtractionResult) -> list[dict]:
        """The save stage's field rows (reference :344-488): each field with
        its key and value boxes on the layout, its confidence clamped to
        [0, 1], and the page of its value box (else of its key box)."""
        layout = ocr.combined_layout_boxes
        rows = []
        for f in result.fields:
            key_bbox, value_bbox = self.matcher.find_key_value_pair(
                f.field_key, f.field_value, layout
            )
            page_no = 1
            if value_bbox:
                page_no = value_bbox.get("page", 1)
            elif key_bbox:
                page_no = key_bbox.get("page", 1)
            rows.append(
                {
                    "field_key": f.field_key,
                    "field_value": f.field_value,
                    "field_type": f.field_type,
                    "confidence": max(0.0, min(f.confidence, 1.0)),
                    "key_bbox": key_bbox,
                    "value_bbox": value_bbox,
                    "original_ocr_text": f.field_value,
                    "page_number": page_no,
                }
            )
        return rows

    def validate(self, rows: list[dict]) -> ExtractionValidationReport:
        """The validate stage (reference :731-756) on the field rows, its
        results keyed by row index."""
        return self.validation.validate_fields(
            [
                {
                    "key": i,
                    "value": r["field_value"],
                    "field_type": r["field_type"],
                    "confidence": r["confidence"],
                }
                for i, r in enumerate(rows)
            ]
        )
