"""Extraction orchestration: the staged OCR -> extract -> save -> validate
workflow with retries, checkpointing and audit logging (port of
ocr_system_tpu/service/orchestrator.py).

- ocr: ``engine.process_document`` on the uploaded file, retried;
- extract: the extractor on the document's word boxes (or its markdown,
  for an extractor without ``extract_from_layout``), with retries, then the
  engine's tables, selection marks and handwriting merged in as table,
  checkbox and signature fields, each merge guarded so that its failure
  costs only its own fields;
- save: each page's processed image as a JPEG (``engine/jpeg.py``, the
  port's own encoder), the page dimensions, the layout, and each field
  paired with the key and value boxes of the layout
  (``BoundingBoxMatcher.find_key_value_pair``), its confidence clamped to
  [0, 1], written to the database with the extraction's statistics;
- validate: ``ValidationService.validate_fields`` over the saved rows.

``extract_document`` runs them as a small state machine: each completed
stage is checkpointed in memory by document id, so a retried run resumes
after the last completed stage (a new extraction id or new inputs start
over); every stage logs to the processing log, which never raises; a
failure marks the document and the extraction failed. ``fields_for`` runs
the extract, save and validate logic on one ``DocumentOCRResult`` without
the database, the report keyed by row index where the database keys it by
field id.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable

import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.db.connection import Database, get_database
from ocr_system_tpu_torch.db.crud import Repositories
from ocr_system_tpu_torch.engine.handwriting import handwriting_to_fields, squiggle_overrides
from ocr_system_tpu_torch.engine.pipeline import DocumentOCRResult, get_engine
from ocr_system_tpu_torch.engine.preprocess import encode_jpeg
from ocr_system_tpu_torch.engine.selection_marks import marks_to_fields
from ocr_system_tpu_torch.extract.layout_model import get_extractor
from ocr_system_tpu_torch.extract.types import ExtractedField, ExtractionResult
from ocr_system_tpu_torch.service.bbox_matcher import BoundingBoxMatcher
from ocr_system_tpu_torch.service.validation import (
    ExtractionValidationReport,
    ValidationService,
)
from ocr_system_tpu_torch.utils.file_manager import FileManager

logger = logging.getLogger(__name__)


@dataclass
class RetryPolicy:
    """Reference RetryPolicy (extraction_service.py:169-183)."""

    max_attempts: int = 2
    initial_interval: float = 0.5
    backoff_factor: float = 2.0


@dataclass
class WorkflowState:
    document_id: str
    file_path: str
    filename: str
    extraction_id: str | None = None
    template: dict | None = None
    custom_prompt: str | None = None
    ocr_result: DocumentOCRResult | None = None
    extract_result: ExtractionResult | None = None
    ocr_time_ms: int = 0
    llm_time_ms: int = 0
    completed_stages: list[str] = dc_field(default_factory=list)


class Checkpointer:
    """In-memory stage checkpoint store keyed by document_id (reference
    InMemorySaver with thread_id=document_id, extraction_service.py:568-571)."""

    def __init__(self):
        self._store: dict[str, WorkflowState] = {}
        self._lock = threading.Lock()

    def load(self, document_id: str) -> WorkflowState | None:
        with self._lock:
            return self._store.get(document_id)

    def save(self, state: WorkflowState) -> None:
        with self._lock:
            self._store[state.document_id] = state

    def clear(self, document_id: str) -> None:
        with self._lock:
            self._store.pop(document_id, None)


class ExtractionOrchestrator:
    """The ExtractionService facade (reference extraction_service.py:794-985).
    ``engine`` and ``extractor`` default to ``get_engine`` and
    ``get_extractor`` of ``settings`` on ``device`` (the card unless the
    caller asks for the CPU), ``db`` to the process database, opened at its
    first use (``fields_for`` needs none)."""

    def __init__(
        self,
        settings: Settings | None = None,
        engine=None,
        extractor=None,
        device: str | torch.device | None = None,
        db: Database | None = None,
    ):
        self.settings = settings or get_settings()
        self._db = db
        self._repos: Repositories | None = None
        self.engine = engine or get_engine(self.settings, device=device)
        self.extractor = extractor or get_extractor(self.settings, device=device)
        self.validation = ValidationService(self.settings)
        self.matcher = BoundingBoxMatcher()
        self.checkpointer = Checkpointer()
        self.ocr_retry = RetryPolicy(max_attempts=2)
        self.extract_retry = RetryPolicy(max_attempts=2)

    @property
    def repos(self) -> Repositories:
        if self._repos is None:
            self._repos = Repositories(self._db or get_database())
        return self._repos

    # ---- audit (reference log_processing_step :491-516: never raises) ----

    def _log(self, document_id, step, status, message=None, extraction_id=None,
             details=None, duration_ms=None):
        try:
            self.repos.logs.log_step(
                document_id, step, status, message=message,
                extraction_id=extraction_id, details=details,
                duration_ms=duration_ms,
            )
        except Exception:
            logger.exception("processing log write failed (non-fatal)")

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
        result = self.extract_fields(ocr, template, custom_prompt)
        rows = self.field_rows(ocr, result)
        return result, rows, self.validate(rows)

    # ---- stages ----

    def _stage_ocr(self, state: WorkflowState) -> None:
        t0 = time.perf_counter()
        self._log(state.document_id, "ocr", "started", extraction_id=state.extraction_id)

        def run():
            with open(state.file_path, "rb") as f:
                data = f.read()
            result = self.engine.process_document(data, state.filename)
            if not result.success:
                raise RuntimeError(result.error or "OCR failed")
            return result

        state.ocr_result = self._with_retry(run, self.ocr_retry, "ocr")
        state.ocr_time_ms = int((time.perf_counter() - t0) * 1000)
        self._log(
            state.document_id, "ocr", "completed",
            extraction_id=state.extraction_id,
            details={
                "pages": state.ocr_result.total_pages,
                "boxes": len(state.ocr_result.combined_layout_boxes),
                # the scheduler's per-stage breakdown (det_wait, rec)
                "stage_times_ms": getattr(state.ocr_result, "stage_times_ms", {}),
            },
            duration_ms=state.ocr_time_ms,
        )

    def _stage_extract(self, state: WorkflowState) -> None:
        t0 = time.perf_counter()
        self._log(state.document_id, "llm_extraction", "started",
                  extraction_id=state.extraction_id)
        assert state.ocr_result is not None
        state.extract_result = self.extract_fields(
            state.ocr_result, state.template, state.custom_prompt)
        state.llm_time_ms = int((time.perf_counter() - t0) * 1000)
        self._log(
            state.document_id, "llm_extraction", "completed",
            extraction_id=state.extraction_id,
            details={"fields": len(state.extract_result.fields)},
            duration_ms=state.llm_time_ms,
        )

    def _stage_save(self, state: WorkflowState) -> None:
        """Reference save_extraction_to_database (:344-488)."""
        t0 = time.perf_counter()
        self._log(state.document_id, "save", "started", extraction_id=state.extraction_id)
        ocr, ext = state.ocr_result, state.extract_result
        assert ocr is not None and ext is not None
        fm = FileManager(self.settings)
        image_paths: dict[str, str] = {}
        page_dims: dict[str, dict] = {}
        for page in ocr.pages:
            if page.processed_image is not None:
                p = fm.save_processed_image(
                    state.document_id, page.page_number,
                    encode_jpeg(page.processed_image, self.settings.jpeg_quality),
                )
                image_paths[str(page.page_number)] = str(p)
            page_dims[str(page.page_number)] = {
                "width": page.page_width,
                "height": page.page_height,
            }
        layout = ocr.combined_layout_boxes
        self.repos.extractions.update(
            state.extraction_id,
            status="completed",
            raw_ocr_markdown=ocr.combined_markdown,
            raw_ocr_html=ocr.combined_html,
            raw_ocr_json={"pages": [p.json_content for p in ocr.pages]},
            form_type=ext.form_type,
            language=ext.language,
            model_name=getattr(self.extractor, "name", "rules"),
            custom_prompt=state.custom_prompt,
            ocr_time_ms=state.ocr_time_ms,
            llm_time_ms=state.llm_time_ms,
            processing_time_ms=state.ocr_time_ms + state.llm_time_ms,
            token_count=ext.token_count,
            layout_data=layout,
            processed_image_paths=image_paths,
            page_dimensions=page_dims,
        )
        self.repos.fields.bulk_create(state.extraction_id, self.field_rows(ocr, ext))
        self.repos.extractions.update_stats(state.extraction_id, self.settings)
        self._log(
            state.document_id, "save", "completed",
            extraction_id=state.extraction_id,
            duration_ms=int((time.perf_counter() - t0) * 1000),
        )

    def _stage_validate(self, state: WorkflowState) -> None:
        """Auto-validation against the saved rows' ids; failure is non-fatal
        (reference :731-756)."""
        t0 = time.perf_counter()
        try:
            fields = self.repos.fields.list_for_extraction(state.extraction_id)
            report = self.validation.validate_fields(
                [
                    {
                        "key": f["id"],
                        "value": f["field_value"],
                        "field_type": f["field_type"],
                        "confidence": f["confidence"],
                    }
                    for f in fields
                ]
            )
            self.repos.fields.bulk_update_validation(
                {
                    fid: (r.is_valid, r.message, r.needs_review)
                    for fid, r in report.results.items()
                }
            )
            self._log(
                state.document_id, "validation", "completed",
                extraction_id=state.extraction_id,
                details={
                    "valid": report.valid_fields,
                    "invalid": report.invalid_fields,
                    "needs_review": report.needs_review,
                },
                duration_ms=int((time.perf_counter() - t0) * 1000),
            )
        except Exception as e:
            logger.exception("validation stage failed (non-fatal)")
            self._log(
                state.document_id, "validation", "failed", message=str(e),
                extraction_id=state.extraction_id,
            )

    # ---- workflow ----

    _STAGES: tuple[tuple[str, str], ...] = (
        ("ocr", "_stage_ocr"),
        ("extract", "_stage_extract"),
        ("save", "_stage_save"),
        ("validate", "_stage_validate"),
    )

    def extract_document(
        self,
        document_id: str,
        template: dict | None = None,
        custom_prompt: str | None = None,
        extraction_id: str | None = None,
    ) -> dict:
        """Run (or resume) the full workflow for a document. Returns the final
        extraction row. Reference extract_document (:824-903)."""
        doc = self.repos.documents.get_active(document_id)
        if doc is None:
            raise ValueError(f"document {document_id} not found")

        self.repos.documents.update_status(document_id, "processing")

        # resume from a checkpoint only when this request targets the same
        # extraction with the same inputs: a failed run leaves its
        # checkpoint behind, and a new request (a new extraction id, or
        # another template or prompt) resuming it would leave the new
        # current row at 'processing' forever
        state = self.checkpointer.load(document_id)
        if state is not None and state.extraction_id is not None:
            requested_new = (
                extraction_id is not None
                and extraction_id != state.extraction_id
            )
            changed_inputs = (
                template != state.template
                or custom_prompt != state.custom_prompt
            )
            if requested_new or changed_inputs:
                self.checkpointer.clear(document_id)
                state = None
        if state is None or state.extraction_id is None:
            if extraction_id is None:
                ext_row = self.repos.extractions.create_new_version(
                    document_id, status="processing"
                )
                extraction_id = ext_row["id"]
            state = WorkflowState(
                document_id=document_id,
                file_path=doc["file_path"],
                filename=doc["original_filename"],
                extraction_id=extraction_id,
                template=template,
                custom_prompt=custom_prompt,
            )

        deadline = time.monotonic() + self.settings.extraction_timeout_s
        try:
            for stage_name, method in self._STAGES:
                if stage_name in state.completed_stages:
                    continue
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"extraction exceeded "
                        f"{self.settings.extraction_timeout_s:.0f}s budget "
                        f"before stage '{stage_name}'"
                    )
                getattr(self, method)(state)
                state.completed_stages.append(stage_name)
                self.checkpointer.save(state)
        except Exception as e:
            self._mark_failed(state, str(e))
            raise
        finally:
            if set(s for s, _ in self._STAGES) <= set(state.completed_stages):
                self.checkpointer.clear(document_id)

        self.repos.documents.update_status(document_id, "completed")
        return self.repos.extractions.get(state.extraction_id)

    def _mark_failed(self, state: WorkflowState, error: str) -> None:
        """Reference mark_document_failed (:519-530)."""
        self._log(state.document_id, "save", "failed", message=error,
                  extraction_id=state.extraction_id)
        try:
            self.repos.documents.update_status(state.document_id, "failed", error)
            if state.extraction_id:
                self.repos.extractions.update(
                    state.extraction_id, status="failed", error_message=error
                )
        except Exception:
            logger.exception("failed to mark document failed")

    # ---- stage logic ----

    def extract_fields(
        self,
        ocr: DocumentOCRResult,
        template: dict | None = None,
        custom_prompt: str | None = None,
    ) -> ExtractionResult:
        """The extract stage's logic: the extractor with retries, then the
        table, checkbox and signature merges."""
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


_orchestrator: ExtractionOrchestrator | None = None
_orch_lock = threading.Lock()


def get_orchestrator() -> ExtractionOrchestrator:
    global _orchestrator
    if _orchestrator is None:
        with _orch_lock:
            if _orchestrator is None:
                _orchestrator = ExtractionOrchestrator()
    return _orchestrator


def set_orchestrator(orch: ExtractionOrchestrator | None) -> None:
    global _orchestrator
    _orchestrator = orch
