"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` (plain ``extern "C"`` launchers, no
PyTorch headers: a build takes seconds, not minutes) into one shared
library under ``build/torch_kernels/<hash of the sources and flags>/`` at
the repository root, on first use. The build writes a temporary name and
``os.replace``s it into place, so a killed build leaves nothing that a later
run would load (``native/build.compile_once``, shared with the native host
library). The library is opened with ``ctypes``; pointers and the
stream travel as ``c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from pathlib import Path

import torch

from ocr_system_tpu_torch.core.mesh import DATA_AXIS, shard_coords
from ocr_system_tpu_torch.native.build import compile_once

_PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (register and shared-memory use per kernel)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ocr_enhance": [_P, _I, _P, _I, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "ocr_crop": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


class LaunchCounter:
    """Launches of one kernel, counted where its wrapper launches it (the
    scheduler's det worker and the main thread both launch); ``by_shard``
    splits them by the dp shard that launched (``core.mesh.shard_scope``;
    -1 outside one)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0
        self.by_shard: dict[int, int] = {}

    def add(self) -> None:
        shard = shard_coords().get(DATA_AXIS, -1)
        with self._lock:
            self.value += 1
            self.by_shard[shard] = self.by_shard.get(shard, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0
            self.by_shard = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libocr_kernels.so"


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path."""
    global build_log
    so = library_path()
    log = compile_once(so, [_nvcc(), *NVCC_FLAGS, *map(str, SOURCES)])
    if log is not None:
        build_log = log
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


OUT_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels write


def check_out_dtype(out_dtype: torch.dtype, name: str) -> None:
    """Raise unless the kernels can write ``out_dtype``."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t from a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError_t {rc}")
