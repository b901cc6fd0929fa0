"""Stage timing (port of ocr_system_tpu/utils/profiler.py StageTimer)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator


@dataclass
class StageTimer:
    """Accumulates named stage durations in milliseconds."""

    stages: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            ) * 1000.0

    def as_ms(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.stages.items()}
