"""Stage timing and device memory (port of ocr_system_tpu/utils/profiler.py:
StageTimer, device_memory_stats)."""

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


def device_memory_stats() -> list[dict]:
    """Per CUDA device: its name and memory (``torch.cuda``: bytes
    allocated by tensors, their peak, the device's free and total bytes);
    an empty list without a card."""
    import torch

    out = []
    for i in range(torch.cuda.device_count()):
        entry = {"device": f"cuda:{i}", "name": torch.cuda.get_device_name(i),
                 "platform": "gpu"}
        try:
            free, total = torch.cuda.mem_get_info(i)
            entry.update({
                "bytes_in_use": torch.cuda.memory_allocated(i),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_free": free,
                "bytes_limit": total,
            })
        except Exception:
            entry["memory_stats"] = "unavailable"
        out.append(entry)
    return out
