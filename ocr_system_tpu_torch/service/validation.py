"""Field validation: 12 type-specific validators with auto-correction
(port of ocr_system_tpu/service/validation.py).

Behavior parity with the reference's validation service
(backend/services/validation_service.py:128-600): same field types, same
acceptance rules, same auto-corrections (ISO date rewrite, space-stripped
email, numeric-extracted currency), same confidence-tier gating (low
confidence => needs_review), and the same pre-finalization gate
(:859-879). Structure differs: validators share small helpers instead of 12
near-identical function bodies, and batch validation is a pure function over
field dicts — DB write-back lives in the orchestrator, keeping this module
side-effect free and trivially testable.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from datetime import datetime
from enum import Enum
from typing import Callable

from ocr_system_tpu_torch.core.config import Settings, get_settings


class FieldType(str, Enum):
    """Reference FieldType enum (models.py:58-71)."""

    TEXT = "text"
    NUMBER = "number"
    DATE = "date"
    EMAIL = "email"
    PHONE = "phone"
    CHECKBOX = "checkbox"
    TABLE = "table"
    SIGNATURE = "signature"
    ADDRESS = "address"
    NAME = "name"
    CURRENCY = "currency"
    UNKNOWN = "unknown"


@dataclass
class ValidationResult:
    is_valid: bool
    message: str
    severity: str = "info"  # info | warning | error
    corrected_value: str | None = None
    needs_review: bool = False
    confidence_level: str = "low"


# --- patterns (reference validation_service.py:128-170) ---

EMAIL_RE = re.compile(r"^[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}$")
PHONE_RES = [
    re.compile(r"^\+?1?\s*\(?[0-9]{3}\)?[-.\s]?[0-9]{3}[-.\s]?[0-9]{4}$"),  # US
    re.compile(r"^\+91[\s-]?[6-9][0-9]{9}$"),  # India
    re.compile(r"^\+?[\d\s\-\(\)\.]{7,20}$"),  # generic international
]
DATE_FORMATS = (
    "%Y-%m-%d", "%d/%m/%Y", "%m/%d/%Y", "%d-%m-%Y", "%d %b %Y",
    "%d %B %Y", "%B %d, %Y", "%b %d, %Y", "%Y/%m/%d",
)
CURRENCY_RE = re.compile(
    r"^[\$\£\€\₹\¥]?\s*[\d,]+\.?\d*$|^[\d,]+\.?\d*\s*[\$\£\€\₹\¥]?$"
)
NUMBER_RE = re.compile(r"^-?[\d,]+\.?\d*$")
CHECKBOX_VALUES = {
    "yes", "true", "checked", "1", "on", "x", "✓", "✔", "y",
    "no", "false", "unchecked", "0", "off", "", "n",
}
NAME_RE = re.compile(r"^[a-zA-Z\s\.\-\']+$")
DATE_LIKE_RE = re.compile(r"\d+[\/\-\.]\d+[\/\-\.]\d+")


def confidence_level(conf: float, settings: Settings | None = None) -> str:
    s = settings or get_settings()
    if conf >= s.confidence_threshold_high:
        return "high"
    if conf >= s.confidence_threshold_medium:
        return "medium"
    return "low"


# --- validators ---


def _empty(value: str | None) -> bool:
    return not value or not value.strip()


def _result(ok, msg, conf, s, severity="info", corrected=None, review=False):
    return ValidationResult(
        is_valid=ok,
        message=msg,
        severity=severity,
        corrected_value=corrected,
        needs_review=review,
        confidence_level=confidence_level(conf, s),
    )


def validate_email(value, conf, s):
    if _empty(value):
        return _result(False, "Email field is empty", conf, s, "error")
    v = value.strip().lower()
    if EMAIL_RE.match(v):
        return _result(True, "Valid email format", conf, s)
    if " " in v:
        corrected = v.replace(" ", "")
        if EMAIL_RE.match(corrected):
            return _result(
                False, f"Email contains spaces - did you mean: {corrected}",
                conf, s, "warning", corrected,
            )
    return _result(False, "Invalid email format", conf, s, "error")


def validate_phone(value, conf, s):
    if _empty(value):
        return _result(False, "Phone number is empty", conf, s, "error")
    v = value.strip()
    if any(p.match(v) for p in PHONE_RES):
        return _result(True, "Valid phone format", conf, s)
    digits = re.sub(r"\D", "", v)
    if 7 <= len(digits) <= 15:
        return _result(
            True, "Phone number has valid digit count", conf, s,
            review=conf < (s or get_settings()).confidence_threshold_high,
        )
    return _result(
        False,
        f"Invalid phone number (found {len(digits)} digits, expected 7-15)",
        conf, s, "error",
    )


def validate_date(value, conf, s):
    if _empty(value):
        return _result(False, "Date field is empty", conf, s, "error")
    v = value.strip()
    for fmt in DATE_FORMATS:
        try:
            iso = datetime.strptime(v, fmt).strftime("%Y-%m-%d")
        except ValueError:
            continue
        return _result(
            True, f"Valid date: {iso}", conf, s,
            corrected=iso if iso != v else None,
        )
    if DATE_LIKE_RE.search(v):
        return _result(
            False, "Date format not recognized - please verify", conf, s,
            "warning", review=True,
        )
    return _result(False, "Invalid date format", conf, s, "error")


def validate_number(value, conf, s):
    if _empty(value):
        return _result(False, "Number field is empty", conf, s, "error")
    v = value.strip().replace(",", "").replace(" ", "")
    if NUMBER_RE.match(v):
        try:
            float(v)
            return _result(True, "Valid number", conf, s)
        except ValueError:
            pass
    digits = sum(c.isdigit() for c in v)
    if digits / max(len(v), 1) > 0.8:
        return _result(
            False, "Value appears to be a number but has invalid characters",
            conf, s, "warning", review=True,
        )
    return _result(False, "Invalid number format", conf, s, "error")


def validate_currency(value, conf, s):
    if _empty(value):
        return _result(False, "Currency field is empty", conf, s, "error")
    v = value.strip()
    if CURRENCY_RE.match(v):
        return _result(True, "Valid currency format", conf, s)
    numeric = re.sub(r"[^\d.,]", "", v)
    if numeric and NUMBER_RE.match(numeric.replace(",", "")):
        return _result(True, "Currency value extracted", conf, s, corrected=numeric)
    return _result(False, "Invalid currency format", conf, s, "error")


def validate_checkbox(value, conf, s):
    v = (value or "").strip().lower()
    if v in CHECKBOX_VALUES:
        return _result(True, "Valid checkbox value", conf, s)
    return _result(
        False,
        f"Unrecognized checkbox value: '{value}' (expected yes/no, true/false, etc.)",
        conf, s, "warning", review=True,
    )


def validate_name(value, conf, s):
    if _empty(value):
        return _result(False, "Name field is empty", conf, s, "error")
    v = value.strip()
    if len(v) < 2:
        return _result(False, "Name too short", conf, s, "error")
    if re.search(r"\d", v):
        return _result(False, "Name contains numbers", conf, s, "warning", review=True)
    if NAME_RE.match(v):
        return _result(True, "Valid name format", conf, s)
    # international names with non-ASCII letters remain valid
    return _result(
        True, "Name contains special characters - please verify", conf, s,
        review=conf < (s or get_settings()).confidence_threshold_high,
    )


def validate_address(value, conf, s):
    if _empty(value):
        return _result(False, "Address field is empty", conf, s, "error")
    if len(value.strip()) < 10:
        return _result(
            False, "Address seems too short", conf, s, "warning", review=True
        )
    return _result(
        True, "Address format accepted", conf, s,
        review=conf < (s or get_settings()).confidence_threshold_medium,
    )


def validate_text(value, conf, s):
    st = s or get_settings()
    if _empty(value):
        return _result(
            True, "Text field is empty", conf, s,
            review=conf < st.confidence_threshold_high,
        )
    return _result(
        True, "Text field accepted", conf, s,
        review=conf < st.confidence_threshold_medium,
    )


def validate_signature(value, conf, s):
    if _empty(value):
        return _result(
            False, "Signature not detected", conf, s, "warning", review=True
        )
    return _result(
        True, "Signature detected", conf, s,
        review=conf < (s or get_settings()).confidence_threshold_medium,
    )


def validate_table(value, conf, s):
    if _empty(value):
        return _result(False, "Table data is empty", conf, s, "warning", review=True)
    return _result(True, "Table data present", conf, s, review=True)


def validate_unknown(value, conf, s):
    return _result(True, "Field type unknown - please review", conf, s, review=True)


VALIDATORS: dict[str, Callable] = {
    FieldType.EMAIL.value: validate_email,
    FieldType.PHONE.value: validate_phone,
    FieldType.DATE.value: validate_date,
    FieldType.NUMBER.value: validate_number,
    FieldType.CURRENCY.value: validate_currency,
    FieldType.CHECKBOX.value: validate_checkbox,
    FieldType.NAME.value: validate_name,
    FieldType.ADDRESS.value: validate_address,
    FieldType.TEXT.value: validate_text,
    FieldType.SIGNATURE.value: validate_signature,
    FieldType.TABLE.value: validate_table,
    FieldType.UNKNOWN.value: validate_unknown,
}


@dataclass
class ExtractionValidationReport:
    """Batch result (reference validate_extraction, validation_service.py:775-857)."""

    total_fields: int = 0
    valid_fields: int = 0
    invalid_fields: int = 0
    needs_review: int = 0
    results: dict[str, ValidationResult] = dc_field(default_factory=dict)

    @property
    def is_valid(self) -> bool:
        return self.invalid_fields == 0


class ValidationService:
    """Facade matching the reference's service surface
    (validation_service.py:649-889)."""

    def __init__(self, settings: Settings | None = None):
        self.settings = settings or get_settings()

    def validate_field(
        self, value: str | None, field_type: str, confidence: float
    ) -> ValidationResult:
        validator = VALIDATORS.get(field_type, validate_unknown)
        result = validator(value, confidence, self.settings)
        # low confidence always flags review regardless of type rule
        if confidence < self.settings.confidence_threshold_medium:
            result.needs_review = True
        return result

    def validate_fields(self, fields: list[dict]) -> ExtractionValidationReport:
        """fields: [{"key", "value", "field_type", "confidence"}, ...]."""
        report = ExtractionValidationReport(total_fields=len(fields))
        for f in fields:
            r = self.validate_field(
                f.get("value"), f.get("field_type", "unknown"), f.get("confidence", 0.0)
            )
            report.results[f["key"]] = r
            if r.is_valid:
                report.valid_fields += 1
            else:
                report.invalid_fields += 1
            if r.needs_review:
                report.needs_review += 1
        return report

    def validate_before_finalization(
        self, fields: list[dict]
    ) -> tuple[bool, list[str]]:
        """Finalization gate (reference validation_service.py:859-879):
        blocks when any field is invalid; returns (ok, blocking messages)."""
        report = self.validate_fields(fields)
        problems = [
            f"{key}: {r.message}"
            for key, r in report.results.items()
            if not r.is_valid and r.severity == "error"
        ]
        return len(problems) == 0, problems
