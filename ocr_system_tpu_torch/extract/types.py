"""Extraction result types (port of ocr_system_tpu/extract/types.py).

Mirrors the reference's LLM response contract
(gemini_service.py:43-104: ExtractedFieldSchema / ExtractionResponseSchema /
GeminiExtractionResult) so the orchestrator and persistence layers see the
same shape whether fields come from the rule engine or the layout model.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ExtractedField:
    field_key: str
    field_value: str
    field_type: str = "text"
    confidence: float = 0.85

    def to_dict(self) -> dict:
        return {
            "field_key": self.field_key,
            "field_value": self.field_value,
            "field_type": self.field_type,
            "confidence": self.confidence,
        }


@dataclass
class ExtractionResult:
    fields: list[ExtractedField] = field(default_factory=list)
    form_type: str = "Unknown"
    language: str = "en"
    raw_response: str | None = None
    processing_time_ms: int = 0
    token_count: int = 0
    success: bool = True
    error: str | None = None

    def to_dict(self) -> dict:
        return {
            "fields": [f.to_dict() for f in self.fields],
            "form_type": self.form_type,
            "language": self.language,
            "raw_response": self.raw_response,
            "processing_time_ms": self.processing_time_ms,
            "token_count": self.token_count,
            "success": self.success,
            "error": self.error,
        }
