"""The card machine's package list as a test: the port and chip_smoke.py
import and run with jax, flax, optax, orbax, pydantic, cv2, PIL, safetensors
and the JAX package all refused."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ocr_system_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "orbax", "pydantic", "cv2", "PIL",
           "safetensors", "ocr_system_tpu")

SCRIPT = r'''
import importlib, pkgutil, sys

BLOCKED = %r

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused on the card machine: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]

import torch
torch.set_num_threads(1)
import ocr_system_tpu_torch
for info in pkgutil.walk_packages(ocr_system_tpu_torch.__path__, "ocr_system_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke as cs

from ocr_system_tpu_torch.utils.smoke import build_engine, letter_pages
engine = build_engine("cpu", det_image_buckets=(128,), rec_width_buckets=(80, 160),
                      rec_batch_size=8, det_batch_size=4)
rec = cs.phase_recognizer(engine.recognizer, 2, 128, per_page=24)
eng = cs.phase_engine(engine, letter_pages(4, 128, rotated=1, seed=1), rotated=1)
sch = cs.phase_scheduler(engine, letter_pages(6, 128, rotated=None, seed=2))
assert sch["waves"] == 2 and sch["retried_pages"] == 0, sch
assert eng["words"] == 4 and sch["words"] == 6, (eng, sch)
print("OK", rec["launches"], eng["launches"], sch["launches"])
''' % (BLOCKED,)


def test_port_runs_without_the_jax_stack():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")


# the one sanctioned lazy import: image decoding needs PIL, the serving
# path does not (the subprocess test above runs the path without it)
ALLOWED = {("ocr_system_tpu_torch/engine/preprocess.py", "decode_image", "PIL")}


def _imports(path: Path):
    """(enclosing function or None, imported root module) pairs."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                out.extend((func, a.name.split(".")[0]) for a in child.names)
            elif (isinstance(child, ast.ImportFrom) and child.level == 0
                  and child.module):
                out.append((func, child.module.split(".")[0]))
            visit(child, func)

    visit(ast.parse(path.read_text()), None)
    return out


def test_no_port_file_imports_a_refused_module():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), func, mod)
        for f in files
        for func, mod in _imports(f)
        if mod in BLOCKED
    ]
    assert set(bad) <= ALLOWED, bad


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    """No CUDA device here: it exits nonzero and prints no result, and so it
    does alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
