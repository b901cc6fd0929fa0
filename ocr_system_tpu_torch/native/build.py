"""Build and load the port's native host library.

``g++`` compiles ``cc_label.cpp`` and ``ink_walk.cpp`` (plain ``extern "C"``
functions) into ``build/torch_native/<hash>/libocrnative.so`` at the
repository root, on first use and never at import. The hash covers the
sources, the flags, ``g++ --version`` and the host's CPU model and
feature flags, because ``-march=native`` code built on one host may not
run on another. A missing ``g++`` or a failed compile raises: nothing
falls back to the plain versions (``native/plain.py``).

``compile_once`` is shared with the CUDA build (``kernels/_build.py``): it
compiles to a temporary name and ``os.replace``s it into place, so that
processes building at once each install a whole library and a killed build
leaves nothing that a later run would load.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "cc_label.cpp", _DIR / "ink_walk.cpp")
BUILD_ROOT = _DIR.parents[1] / "build" / "torch_native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libocrnative.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compile_once(so: Path, cmd: list[str]) -> str | None:
    """Run ``cmd`` (a compiler command without its output) to build ``so``
    unless it exists; returns the compiler's output, or None when ``so``
    was already built. Raises on a failed compile."""
    if so.is_file():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return log


def compiler() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native host ops cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def compiler_version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]


def cpu_model() -> str:
    """The host CPU's model name and feature flags (a virtual machine may
    name different CPUs alike; ``-march=native`` compiles for the flags)."""
    found: dict[str, str] = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            key = key.strip()
            if key in ("model name", "flags") and key not in found:
                found[key] = value.strip()
    except OSError:
        pass
    return " | ".join(found.values()) or platform.processor() or platform.machine()


def library_path(root: Path = BUILD_ROOT) -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(compiler_version(compiler()).encode())
    h.update(cpu_model().encode())
    return root / h.hexdigest()[:16] / LIB_NAME


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path."""
    so = library_path(root)
    compile_once(so, [compiler(), *FLAGS, *map(str, SOURCES)])
    return so


_I32 = ctypes.c_int32
_P = ctypes.c_void_p
_SIGNATURES = {
    "cc_label_u8": (_I32, [_P, _I32, _I32, _P]),
    "cc_block_order": (_I32, [_P, _I32, _I32, _I32]),
    "cc_stats": (None, [_P, _P, _I32, _I32, _I32, _P, _P, _P]),
    "cc_analyze_u8": (_I32, [_P, _I32, _I32, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P]),
    "ink_expand_batch": (None, [_P, _I32, _I32, _P, _I32, ctypes.c_float]),
}


def library() -> ctypes.CDLL:
    """The loaded native library, built on first use. ``ctypes.CDLL``
    releases the GIL for each call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib
