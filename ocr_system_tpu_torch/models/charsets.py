"""Character sets for the recognition head.

Per BASELINE configs 1 and 3 the framework must cover English printed forms
and Hindi (Devanagari) — the reference gets this for free from Azure
(ocr_service.py) and tests it with backend/test_image_hindi.png. Index 0 is
always the CTC blank (ops/ctc.py convention).
"""

from __future__ import annotations

import dataclasses
import string
from functools import lru_cache


@dataclasses.dataclass(frozen=True)
class Charset:
    name: str
    chars: str  # symbol i+1 (0 is the CTC blank)

    @property
    def size(self) -> int:
        """Vocabulary size including the blank."""
        return len(self.chars) + 1

    def char_to_id(self, ch: str) -> int:
        idx = self.chars.find(ch)
        return idx + 1 if idx >= 0 else 0  # unknown chars map to blank

    def id_to_char(self, i: int) -> str:
        if i <= 0 or i > len(self.chars):
            return ""
        return self.chars[i - 1]

    def encode(self, text: str) -> list[int]:
        return [self.char_to_id(c) for c in text if self.char_to_id(c) > 0]

    def decode(self, ids) -> str:
        return "".join(self.id_to_char(int(i)) for i in ids)


# Printable ASCII minus control chars; covers English forms, numbers,
# punctuation found on invoices/applications.
_LATIN = string.digits + string.ascii_letters + string.punctuation + " "

# Devanagari block: signs, vowels, consonants, matras, virama, digits, danda.
_DEVANAGARI = "".join(chr(c) for c in range(0x0901, 0x0964)) + "।॥" + "".join(
    chr(c) for c in range(0x0966, 0x0970)
)


@lru_cache(maxsize=None)
def get_charset(name: str) -> Charset:
    if name == "latin":
        return Charset("latin", _LATIN)
    if name == "devanagari":
        # Latin digits/punct commonly co-occur on Hindi forms
        return Charset("devanagari", _DEVANAGARI + string.digits + ".,:/-() ")
    if name == "multilingual":
        return Charset("multilingual", _LATIN + _DEVANAGARI)
    raise ValueError(f"unknown charset {name!r}")
