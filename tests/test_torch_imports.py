"""The card machine's package list as a test: the port and chip_smoke.py
import and run with jax, flax, optax, orbax, pydantic, cv2, PIL, fontTools,
safetensors and the JAX package all refused: every module of the port
imports (the training package's synthetic renderers and the parallel
layer among them), and chip_smoke.py's phases run at a tiny size on the
committed weights and forms, the hybrid engine's, the glue split's, field
extraction's, the service's (a scanned PDF uploaded to the port's app on a
socket, through to its exports), training's (each trainer's steps on a cut
of its committed batch, train_layout through the PIL-free form generator)
and the parallel layer's (the multichip phases on virtual CPU meshes and
the multichip dry run) among them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ocr_system_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "orbax", "pydantic", "cv2", "PIL", "fontTools",
           "safetensors", "ocr_system_tpu")

SCRIPT = r'''
import importlib, pkgutil, sys
import numpy as np

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

from ocr_system_tpu_torch.engine.host_image import resize_linear, rotate_cubic
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.utils import smoke

def pages(arrays):
    return [PageImage(a, i + 1) for i, a in enumerate(arrays)]

# the committed forms and weights, at a tiny size
forms, expected = smoke.smoke_forms()
small = [resize_linear(f, (320, 320)) for f in forms[1:4]]
tiny = dict(det_image_buckets=(320,), rec_width_buckets=(80, 160), rec_batch_size=8,
            det_batch_size=2)
neural = smoke.build_engine("cpu", **smoke.NEURAL, **tiny)
rec = cs.phase_recognizer(neural.recognizer, 2, 128, per_page=24)
turned = list(small)
turned[1] = rotate_cubic(turned[1], 3.0)
eng = cs.phase_engine(neural, pages(turned), rotated=1)
hybrid = smoke.build_engine("cpu", **{**expected["settings"], **tiny})
# the hybrid phase's checks, held against this engine's own first run
first = [smoke.page_record(o) for o in hybrid.process_pages(pages(small))]
hyb = cs.phase_hybrid(hybrid, pages(small), first, 1.0, 1.0, "hybrid", also={"itself": first})
# the mixed wave: the top-left 320 x 320 of two Hindi forms at full
# resolution (text at its own size, so the pages route to Devanagari), then
# a Latin form; held against this engine's own first run, routing and
# rescue counts included
mixed = pages([np.ascontiguousarray(f[:320, :320]) for f in smoke.hindi_forms()[:2]] + small[:1])
first_m = [smoke.page_record(*r) for r in zip(hybrid.process_pages(mixed), hybrid.routed,
                                              hybrid.rescued)]
mix = cs.phase_hybrid(hybrid, mixed, first_m, 1.0, 1.0, "mixed", routing_equal=True, hindi=2,
                      min_hindi_text=1.0)
sch = cs.phase_scheduler(hybrid, pages(small + small[:1]))
host = cs.phase_host_ops(small[0], iters=1)
# the native host library against its plain versions on the served inputs
nat = cs.phase_native(smoke.build_engine("cpu", **smoke.NEURAL, **tiny, det_prob_wire_bits=4),
                      small[:2], iters=1)
assert nat["pages"] == 2 and nat["boxes"] > 0, nat
assert all(r["unequal"] == 0 and r["cases"] == 4 for r in nat["ops"].values()), nat
# glue split at the served rec settings, against the committed JAX record
glue = cs.phase_glue(smoke.build_engine("cpu", **smoke.NEURAL), "bfloat16")
assert sch["waves"] == 2 and sch["retried_pages"] == 0, sch
assert eng["words"] > 0 and hyb["words"] == hyb["words_matched"] > 0, (eng, hyb)
assert hyb["text_share_vs"] == {"itself": 1.0}, hyb
assert set(hyb["stage_ms"]) >= {"det_neural", "det_classical", "glue", "finish"}, hyb
assert len(host["ms"]) == 11 and host["ms"]["cc_stats_native"] > 0, host
assert glue["boxes_after"] > glue["lines"] and glue["texts_equal"], glue
assert mix["devanagari_words"] > 0 and mix["devanagari_dispatch"]["dispatches"] > 0, mix
assert sum(r["confidence"][0] for r in mix["rescued"]) > 0 and all(mix["rescued_ok"]), mix
assert mix["hindi_bar_met"] and mix["hindi_text_share"] == 1.0, mix
assert set(mix["stage_ms"]) >= {"route", "rescue"}, mix
# field extraction: the trained extractor on two committed documents
# against the JAX record, then page to fields on the tiny hybrid engine,
# held against its own first run
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.pipeline import document_result
from ocr_system_tpu_torch.extract.layout_model import get_extractor
from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator

docs = smoke.extract_documents(expected)
docs = {k: docs[k] for k in ("pages/4", "mixed/3")}
want = smoke.extract_expected()["docs"]
ex = get_extractor(Settings(compute_dtype="float32"), device="cpu")
x32 = cs.phase_extract(ex, docs, want["float32"], "extract_f32", True, buckets=(256,))
x16 = cs.phase_extract(get_extractor(Settings(), device="cpu"), docs, want["bfloat16"],
                       "extract_bf16", False, min_share=0.95, buckets=(256,))
orch = ExtractionOrchestrator(hybrid.settings, engine=hybrid, extractor=ex)
r, rows, rep = orch.fields_for(document_result(hybrid.process_pages(pages(small))))
own = {"result": smoke.result_record(r), "rows": smoke.rows_record(rows),
       "report": smoke.report_record(rep)}
e2e = cs.phase_extract_e2e(orch, pages(small), own, "extract_e2e", True)
assert x32["docs_equal"] == 2 and x32["forward"][256]["host_ms"] > 0, x32
assert x16["field_share"] >= 0.95, x16
assert e2e["fields_equal"] and e2e["report_equal"] and e2e["rows"] > 0, e2e
# the service: a scanned PDF of two small forms through the port's app, on
# a socket, to its exports; without PIL the embedded-image tier serves it
import tempfile
from ocr_system_tpu_torch.api.http import Request
from ocr_system_tpu_torch.engine import preprocess

upload = smoke.scanned_pdf([f[..., 0] for f in small[:2]])
with tempfile.TemporaryDirectory() as root:
    app, orch = cs.service_app(hybrid, ex, root, "float32")
    own = smoke.app_upload(app, Request, upload, smoke.SERVICE_UPLOAD.name)
    assert preprocess.RASTER_TIERS == {"embedded": 1}, preprocess.RASTER_TIERS
    app, orch = cs.service_app(hybrid, ex, root + "/again", "float32")
    svc = cs.phase_service(app, orch, upload, own, "service", True)
assert svc["raster_tier"] == {"embedded": 1} and svc["pil"] is None, svc
assert svc["tiers_agree"] == {"embedded_pages": 2, "render": "no PIL"}, svc
assert svc["fields_equal"] and svc["json_equal"] and svc["csv_equal"] and svc["health"] == 200, svc
assert svc["fields_expected"] > 0 and svc["pages"] == 2, svc
assert set(svc["stage_ms"]) >= {"ocr_ms", "llm_extraction_ms", "save_ms", "validation_ms"}, svc
# training: each trainer's steps on the first sample of its committed batch
# (the full models), and train_layout end to end at 64 x 2
want = smoke.train_expected()
for name in smoke.TRAIN_NAMES:
    tr = cs.phase_train(name, "float32", "cpu", want, None, n=1)
    assert len(tr["loss"]) == 3 and tr["host_step_ms"] > 0 and "deviation" not in tr, tr
cli = cs.phase_train_layout_cli("cpu", steps=2, batch_size=2, max_len=64, dim=64, depth=2)
assert cli["host_steps_per_s"] > 0 and np.isfinite(cli["loss_last"]), cli
# the parallel layer on virtual meshes of the CPU: the tiny hybrid wave
# split over dp=4 against the one-device mesh and the engine's first run,
# sp extraction on one committed document, a dp=2 rec step on 2 samples,
# GPipe over the extractor's first 4 blocks, and the dry run of every path
from ocr_system_tpu_torch.core.mesh import build_mesh
from ocr_system_tpu_torch.utils.multichip import dryrun_multichip

own = [smoke.page_record(*r) for r in zip(hybrid.process_pages(pages(small)), hybrid.routed,
                                          hybrid.rescued)]
mcw = cs.phase_dp_wave("cpu", pages(small), own, {**expected["settings"], **tiny},
                       build_mesh("dp=-1", ["cpu"]))
assert mcw["records_equal"] and mcw["meshes"]["dp4"]["distinct_devices"] == 1, mcw
docs4 = {k: docs[k] for k in ("pages/4",)}
sp = cs.phase_sp_extract("cpu", docs4, smoke.extract_expected()["docs"]["float32"],
                         buckets=(256,), logits_at=256)
assert sp["docs_equal"] == 1 and max(sp["logits_rel_diff"].values()) <= 1e-4, sp
tm = cs.phase_train_mesh("rec", "cpu", want, None, cs.virtual_mesh("dp=-1", "cpu", 2), n=2)
gap = np.abs(np.subtract(tm["loss"], tm["one_device_loss"])).max()
assert gap <= 1e-4 * np.abs(tm["one_device_loss"]).max(), tm
gp = cs.phase_gpipe("cpu", n_micro=4, mb=1, tokens=16, depth=4)
assert gp["forward_rel_diff"] <= 1e-5 and gp["ticks"] == 7, gp
dry = dryrun_multichip(4, devices=["cpu"] * 4)
assert dry["distinct_devices"] == 1 and dry["scheduler_waves"] == 2, dry
print("OK", rec["launches"], eng["launches"], hyb["launches"], mix["launches"], sch["launches"],
      e2e["launches"], svc["launches"])
''' % (BLOCKED,)


def test_port_runs_without_the_jax_stack():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")


# the sanctioned lazy imports: image decoding and the PDF renderer's canvas
# need PIL, the serving path does not (the subprocess test above runs the
# path, a scanned PDF upload included, without it); the synthetic line and
# page renderers of training need PIL, and building a font needs fontTools
# (the renderers read a font's coverage from its cmap table), the layout
# trainer's form generator neither
ALLOWED = {("ocr_system_tpu_torch/engine/preprocess.py", "decode_image", "PIL")} | {
    ("ocr_system_tpu_torch/engine/pdf.py", method, "PIL")
    for method in ("__init__", "_pil_font", "_decode_image_xobject", "_paste_image", "finish")} | {
    ("ocr_system_tpu_torch/training/synth.py", method, "PIL")
    for method in ("_font", "render_line", "render_page")} | {
    ("ocr_system_tpu_torch/training/synth_forms.py", "render_spec", "PIL"),
    ("ocr_system_tpu_torch/training/devanagari_font.py", "build_font", "fontTools"),
    ("chip_smoke.py", "pil_version", "PIL"),  # the service phase reports whether PIL imports
    ("chip_smoke.py", "phase_fonts", "PIL"),  # the fonts phase reports PIL's FreeType
    ("ocr_system_tpu_torch/utils/demo.py", "render_invoice", "PIL")}  # the demo draws its page


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


# the parallel layer's modules, each among the files checked below
PARALLEL = ("core/mesh.py", "parallel/sharding.py", "parallel/pipeline.py",
            "parallel/ring_attention.py", "utils/multichip.py")


def test_no_port_file_imports_a_refused_module():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert {PORT / m for m in PARALLEL} <= set(files)
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


# the native host ops and the entry points of the JAX package's scripts:
# the standard library (ctypes for the bindings), numpy, scipy for the
# plain versions, and the port itself; PIL only where ALLOWED says
NEW_MODULES = {
    "native/build.py": set(), "native/cc_label.py": {"numpy"}, "native/ink_walk.py": {"numpy"},
    "native/plain.py": {"numpy", "scipy"}, "db/init_db.py": set(), "db/db_admin.py": set(),
    "utils/debug_engine.py": set(), "utils/demo.py": {"PIL"},
    "training/compare_extractors.py": set(), "training/diag_forms.py": {"numpy"},
    "training/diag_hindi.py": {"numpy"}, "training/diag_extract_pipeline.py": {"numpy"},
    "training/diag_one_doc.py": {"numpy"},
}


def test_new_modules_import_only_the_standard_library():
    for rel, extra in NEW_MODULES.items():
        mods = {m for _, m in _imports(PORT / rel)}
        others = mods - set(sys.stdlib_module_names) - {"ocr_system_tpu_torch", "__future__"}
        assert others == extra, (rel, others)
    assert "ctypes" in {m for _, m in _imports(PORT / "native/build.py")}
