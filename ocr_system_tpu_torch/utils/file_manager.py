"""Storage abstraction (reference: backend/utils/file_manager.py:27-394).

Port of ``ocr_system_tpu/utils/file_manager.py``: the same code, on the port's modules.

Same contract: extension/size validation, unique names
`{prefix}_{ts}_{uuid8}.{ext}`, filename sanitization, date-sharded (YYYY/MM)
upload/export dirs, flat processed-image store `{doc_id}_page{n}.jpg` for the
bbox-overlay UI, stream save, sha256 hashing.
"""

from __future__ import annotations

import hashlib
import re
import time
from pathlib import Path
from uuid import uuid4

from ocr_system_tpu_torch.core.config import Settings, get_settings


class FileValidationError(ValueError):
    pass


class FileManager:
    def __init__(self, settings: Settings | None = None):
        self.settings = settings or get_settings()

    # --- validation (reference :72-96) ---

    def validate_file(self, filename: str, size: int) -> None:
        ext = self.get_extension(filename)
        if ext not in self.settings.allowed_extensions:
            raise FileValidationError(
                f"File type '.{ext}' not allowed; expected one of "
                f"{', '.join(self.settings.allowed_extensions)}"
            )
        if size > self.settings.max_upload_size_bytes:
            raise FileValidationError(
                f"File too large ({size} bytes; limit "
                f"{self.settings.max_upload_size_mb} MB)"
            )
        if size == 0:
            raise FileValidationError("File is empty")

    @staticmethod
    def get_extension(filename: str) -> str:
        return filename.rsplit(".", 1)[-1].lower() if "." in filename else ""

    # --- naming (reference :107-138) ---

    def generate_unique_filename(self, original: str, prefix: str = "doc") -> str:
        ext = self.get_extension(original) or "bin"
        ts = time.strftime("%Y%m%d_%H%M%S")
        return f"{prefix}_{ts}_{uuid4().hex[:8]}.{ext}"

    @staticmethod
    def sanitize_filename(filename: str) -> str:
        name = Path(filename).name
        name = re.sub(r"[^\w\s\.\-]", "", name)
        name = re.sub(r"\s+", "_", name.strip())
        return name[:255] or "unnamed"

    # --- dirs (reference :144-149) ---

    def date_subdir(self, base: Path) -> Path:
        sub = base / time.strftime("%Y") / time.strftime("%m")
        sub.mkdir(parents=True, exist_ok=True)
        return sub

    # --- save (reference :177-291) ---

    def save_upload(self, data: bytes, original_filename: str) -> tuple[Path, str]:
        """Validate, store under uploads/YYYY/MM, return (path, stored name)."""
        self.validate_file(original_filename, len(data))
        name = self.generate_unique_filename(
            self.sanitize_filename(original_filename), prefix="doc"
        )
        path = self.date_subdir(self.settings.upload_path) / name
        path.write_bytes(data)
        return path, name

    def save_export(self, data: bytes, filename: str) -> Path:
        path = self.date_subdir(self.settings.export_path) / filename
        path.write_bytes(data)
        return path

    def save_processed_image(
        self, document_id: str, page_number: int, jpeg_bytes: bytes
    ) -> Path:
        """Flat store for overlay lookup (reference :262-291)."""
        path = self.settings.processed_path / f"{document_id}_page{page_number}.jpg"
        path.write_bytes(jpeg_bytes)
        return path

    def processed_image_path(self, document_id: str, page_number: int) -> Path:
        return self.settings.processed_path / f"{document_id}_page{page_number}.jpg"

    @staticmethod
    def file_hash(data: bytes) -> str:
        return hashlib.sha256(data).hexdigest()
