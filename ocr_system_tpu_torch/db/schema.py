"""Database schema: 6 tables mirroring the reference ORM.

Port of ``ocr_system_tpu/db/schema.py``: the same code, on the port's modules.

Reference (backend/database/models.py):
  Document          :114-249  file meta, status enum, soft delete, JSON metadata
  Extraction        :252-430  versioned results, is_current flag, raw OCR,
                              stats, per-stage timings, layout_data /
                              processed_image_paths / page_dimensions JSON,
                              finalization, UNIQUE(document_id, version)
  ExtractedField    :433-562  key/value/type, confidence (checked 0..1),
                              validation state, edit tracking, key/value bbox
                              JSON, original_ocr_text, page, sort_order
  FieldEdit         :565-631  audit trail
  FormTemplate      :634-718  expected_fields JSON, custom prompt, usage count
  ProcessingLog     :721-796  step/status enums, details JSON, duration_ms

Engine: sqlite (stdlib) instead of Postgres — the schema, enums, and access
patterns are identical; JSONB becomes TEXT+json, uuid PKs are TEXT. WAL mode
gives the single-writer/many-reader profile the API needs.
"""

from __future__ import annotations

from enum import Enum


class DocumentStatus(str, Enum):
    PENDING = "pending"
    UPLOADING = "uploading"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"


class ExtractionStatus(str, Enum):
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"


class EditType(str, Enum):
    MANUAL = "manual"
    SUGGESTION_ACCEPTED = "suggestion_accepted"
    AUTO_CORRECTION = "auto_correction"
    VALIDATION_FIX = "validation_fix"


class ProcessingStep(str, Enum):
    UPLOAD = "upload"
    PREPROCESSING = "preprocessing"
    OCR = "ocr"
    LLM_EXTRACTION = "llm_extraction"
    VALIDATION = "validation"
    SAVE = "save"
    EXPORT = "export"


class StepStatus(str, Enum):
    STARTED = "started"
    COMPLETED = "completed"
    FAILED = "failed"
    SKIPPED = "skipped"


DDL = """
PRAGMA journal_mode=WAL;
PRAGMA foreign_keys=ON;

CREATE TABLE IF NOT EXISTS documents (
    id TEXT PRIMARY KEY,
    filename TEXT NOT NULL,
    original_filename TEXT NOT NULL,
    file_path TEXT NOT NULL,
    file_size INTEGER NOT NULL DEFAULT 0,
    file_type TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    error_message TEXT,
    custom_metadata TEXT,            -- JSON
    is_deleted INTEGER NOT NULL DEFAULT 0,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    processed_at TEXT
);
CREATE INDEX IF NOT EXISTS ix_documents_status
    ON documents(status) WHERE is_deleted = 0;
CREATE INDEX IF NOT EXISTS ix_documents_created ON documents(created_at);

CREATE TABLE IF NOT EXISTS extractions (
    id TEXT PRIMARY KEY,
    document_id TEXT NOT NULL REFERENCES documents(id),
    version INTEGER NOT NULL DEFAULT 1,
    is_current INTEGER NOT NULL DEFAULT 1,
    status TEXT NOT NULL DEFAULT 'pending',
    raw_ocr_markdown TEXT,
    raw_ocr_html TEXT,
    raw_ocr_json TEXT,               -- JSON
    form_type TEXT,
    language TEXT,
    model_name TEXT,
    custom_prompt TEXT,
    total_fields INTEGER NOT NULL DEFAULT 0,
    avg_confidence REAL,
    high_confidence_fields INTEGER NOT NULL DEFAULT 0,
    low_confidence_fields INTEGER NOT NULL DEFAULT 0,
    processing_time_ms INTEGER,
    ocr_time_ms INTEGER,
    llm_time_ms INTEGER,
    token_count INTEGER,
    layout_data TEXT,                -- JSON: combined layout boxes
    processed_image_paths TEXT,      -- JSON: page -> path
    page_dimensions TEXT,            -- JSON: page -> {width, height}
    is_finalized INTEGER NOT NULL DEFAULT 0,
    finalized_at TEXT,
    error_message TEXT,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL,
    UNIQUE(document_id, version)
);
CREATE INDEX IF NOT EXISTS ix_extractions_document
    ON extractions(document_id, is_current);

CREATE TABLE IF NOT EXISTS extracted_fields (
    id TEXT PRIMARY KEY,
    extraction_id TEXT NOT NULL REFERENCES extractions(id),
    field_key TEXT NOT NULL,
    field_value TEXT,
    field_type TEXT NOT NULL DEFAULT 'text',
    confidence REAL NOT NULL DEFAULT 0.0
        CHECK (confidence >= 0.0 AND confidence <= 1.0),
    is_valid INTEGER,
    validation_message TEXT,
    needs_review INTEGER NOT NULL DEFAULT 0,
    is_edited INTEGER NOT NULL DEFAULT 0,
    original_value TEXT,
    key_bbox TEXT,                   -- JSON match dict
    value_bbox TEXT,                 -- JSON match dict
    original_ocr_text TEXT,
    page_number INTEGER NOT NULL DEFAULT 1,
    sort_order INTEGER NOT NULL DEFAULT 0,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_fields_extraction
    ON extracted_fields(extraction_id, sort_order);

CREATE TABLE IF NOT EXISTS field_edits (
    id TEXT PRIMARY KEY,
    field_id TEXT NOT NULL REFERENCES extracted_fields(id),
    extraction_id TEXT NOT NULL REFERENCES extractions(id),
    old_value TEXT,
    new_value TEXT,
    edit_type TEXT NOT NULL DEFAULT 'manual',
    edited_by TEXT,
    created_at TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS form_templates (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    description TEXT,
    expected_fields TEXT,            -- JSON list
    custom_prompt TEXT,
    validation_rules TEXT,           -- JSON
    usage_count INTEGER NOT NULL DEFAULT 0,
    is_active INTEGER NOT NULL DEFAULT 1,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS processing_logs (
    id TEXT PRIMARY KEY,
    document_id TEXT REFERENCES documents(id),
    extraction_id TEXT REFERENCES extractions(id),
    step TEXT NOT NULL,
    status TEXT NOT NULL,
    message TEXT,
    details TEXT,                    -- JSON
    duration_ms INTEGER,
    created_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_logs_document ON processing_logs(document_id);
"""
