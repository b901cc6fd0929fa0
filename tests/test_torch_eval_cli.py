"""The port's evaluation entry points, training/run_evaluate.py and
training/sweep_quality.py, against the JAX package's scripts/evaluate.py
and scripts/sweep_quality.py: exactly their options (and ``--device``);
with every evaluation function and model stubbed in both packages, the
same printed report, ROW and SWEEP lines; a real extraction sweep on the
CPU; the loud refusal of a missing weight file; no card and no
``--device cpu``: a raise. And the new modules run with JAX, the JAX
package, cv2 and fontTools refused, rendering the same pixels."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ocr_system_tpu.engine.classical_detector as jax_classical
import ocr_system_tpu.engine.hybrid_detector as jax_hybrid
import ocr_system_tpu.engine.pipeline as jax_pipeline
import ocr_system_tpu.engine.recognizer as jax_recognizer
import ocr_system_tpu.extract.layout_model as jax_lm
import ocr_system_tpu.training.evaluate as JE
import ocr_system_tpu_torch.engine.recognizer as port_recognizer
import ocr_system_tpu_torch.extract.layout_model as port_lm
import ocr_system_tpu_torch.training.evaluate as E
from ocr_system_tpu_torch.training import run_evaluate, sweep_quality

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {"evaluate": (REPO / "scripts" / "evaluate.py", run_evaluate),
           "sweep_quality": (REPO / "scripts" / "sweep_quality.py", sweep_quality)}


def _literal(node):
    try:
        return ast.literal_eval(node)
    except ValueError:
        return "<computed>"


def _jax_options(path: Path) -> dict[str, tuple]:
    """The script's ``p.add_argument`` calls: option -> (type, default,
    action), a computed default as "<computed>"."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            action = _literal(kw["action"]) if "action" in kw else None
            if "default" in kw:
                default = _literal(kw["default"])
            else:  # argparse's own default
                default = False if action == "store_true" else None
            out[_literal(node.args[0])] = (kw["type"].id if "type" in kw else None, default,
                                           action)
    return out


def _port_options(parser) -> dict[str, tuple]:
    out = {}
    for a in parser._actions:
        if not a.option_strings or a.option_strings == ["-h", "--help"]:
            continue
        action = "store_true" if a.const is True and a.nargs == 0 else None
        out[a.option_strings[0]] = (getattr(a.type, "__name__", None), a.default, action)
    return out


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_options_equal_the_jax_scripts(script):
    """Every option with its type and default, the checkpoint defaults
    (computed: the committed weight files here, the committed orbax
    directories there) aside, plus ``--device``."""
    path, mod = SCRIPTS[script]
    want, got = _jax_options(path), _port_options(mod.parser())
    assert set(got) == set(want) | {"--device"}
    for k, v in want.items():
        if v[1] == "<computed>" or k == "--extract-checkpoint":
            assert got[k][0] == v[0] and got[k][1].endswith(".npz"), k
        else:
            assert got[k] == v, k
    assert got["--device"] == (None, None, None)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Model:
    def __init__(self, *args, **kwargs):
        pass


def _stub(monkeypatch, module) -> None:
    """Each evaluation function of ``module`` (either package's
    training/evaluate) answers a fixed result of its own classes."""
    m = module
    fixed = {
        "evaluate_recognizer": m.RecEvalResult(100, 0.0123456, 0.875, [("ab", "ab")]),
        "evaluate_end_to_end": m.E2EEvalResult(10, 0.0514, 0.93333, 0.0612, 0.0411, 0.0399),
        "evaluate_form_extraction": m.FieldEvalResult(0.91234, 0.8765, 0.8941, 25, 0.96, 3, 120),
        "evaluate_field_extraction": m.FieldEvalResult(1.0, 0.95, 0.9744, 20),
        "evaluate_form_extraction_e2e": {"n_docs": 10, "exact": {"precision": 0.8},
                                         "relaxed_cer_0.25": {"f1": 0.9}},
        "evaluate_signature_detection": {"n_docs": 10, "handwriting_box_rate": 0.9,
                                         "signature_field_rate": 0.8},
    }
    for name, value in fixed.items():
        monkeypatch.setattr(m, name, lambda *a, _v=value, **k: _v)


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' evaluations and models stubbed: the scripts' own
    logic (options, rows, seeds, aggregation, the report) is what runs."""
    _stub(monkeypatch, JE)
    _stub(monkeypatch, E)
    for mod, name in ((jax_recognizer, "Recognizer"), (jax_lm, "LayoutModelExtractor"),
                      (jax_pipeline, "JaxOCREngine"), (jax_hybrid, "HybridDetector"),
                      (jax_classical, "ClassicalDetector"), (port_recognizer, "Recognizer"),
                      (port_lm, "LayoutModelExtractor")):
        monkeypatch.setattr(mod, name, _Model)
    monkeypatch.setattr(run_evaluate, "build_engine", lambda *a, **k: _Model())
    monkeypatch.setattr(sweep_quality, "build_engine", lambda *a, **k: _Model())
    monkeypatch.chdir(REPO)  # the JAX scripts name their checkpoints relative to it


def _run_jax(path: Path, argv: list[str], capsys) -> str:
    mod = _load(path, f"jax_{path.stem}")
    if hasattr(mod, "_engine"):
        mod._engine = lambda *a, **k: _Model()
    old = sys.argv
    sys.argv = [str(path), *argv]
    try:
        mod.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--quick"], ["--seeds", "2", "--pages", "3",
                                                 "--rows", "rec,extract,signatures"]])
def test_sweep_prints_the_jax_rows(argv, stubbed, capsys):
    """The same ROW, trial and SWEEP lines, in the same order."""
    want = _run_jax(SCRIPTS["sweep_quality"][0], argv, capsys)
    sweep_quality.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1].startswith("SWEEP ") and got.count("\nROW ") >= 3


def test_evaluate_prints_the_jax_report(stubbed, capsys):
    argv = ["--forms", "3", "--forms-heldout", "2", "--e2e", "hybrid", "--signatures", "2",
            "--forms-e2e", "2"]
    want = json.loads(_run_jax(SCRIPTS["evaluate"][0], argv, capsys))
    got = json.loads(json.dumps(run_evaluate.main([*argv, "--device", "cpu"])))
    capsys.readouterr()
    # the checkpoint names a weight file here and an orbax directory there
    assert got["recognizer"].pop("checkpoint").endswith("rec_latin.npz")
    assert want["recognizer"].pop("checkpoint").endswith("rec_latin")
    assert got == want


def test_sweep_extract_rows_on_the_cpu(capsys):
    """``--quick --rows extract --forms 2 --device cpu``: the trained model,
    ROW lines with the JAX sweep's keys, and the SWEEP line."""
    report = sweep_quality.main(["--quick", "--rows", "extract", "--forms", "2",
                                 "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    rows = {ln.split(" ", 2)[1]: json.loads(ln.split(" ", 2)[2])
            for ln in lines if ln.startswith("ROW ")}
    assert set(rows) == {"extract_infamily", "extract_heldout"}
    assert set(rows["extract_infamily"]) == {"f1", "precision", "recall", "type_acc"}
    assert set(rows["extract_heldout"]) == {"f1", "precision", "recall"}
    assert lines[-1] == "SWEEP " + json.dumps(report) and report == rows
    assert all(0.0 <= v <= 1.0 for r in rows.values() for v in r.values())


def test_a_missing_weight_file_is_refused(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SWEEP_CKPT_EXTRACT", str(tmp_path / "extract.npz"))
    with pytest.raises(SystemExit, match="random init would lie"):
        sweep_quality.main(["--quick", "--rows", "extract", "--device", "cpu"])
    assert "extract checkpoint OVERRIDE" in capsys.readouterr().err


@pytest.mark.parametrize("entry", [run_evaluate.main, sweep_quality.main])
def test_without_a_card_the_entry_points_raise(entry):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(["--rows", "extract"] if entry is sweep_quality.main else [])


REFUSED = ("jax", "flax", "optax", "orbax", "cv2", "fontTools", "ocr_system_tpu")

SCRIPT = r'''
import sys, json
import numpy as np

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.training import evaluate, run_evaluate, sweep_quality, synth, synth_forms
from ocr_system_tpu_torch.utils.smoke import pixels_digest

out = {}
for cs in ("latin", "devanagari"):
    line = synth.TextRenderer(get_charset(cs), seed=9999).render_line(max_width=320, augment=False)
    out[cs] = pixels_digest((line.image * 255).astype(np.uint8))
page = synth_forms.render_spec(synth_forms.FormGenerator(seed=5556).generate(800), augment=False)
out["form"] = pixels_digest((page.image * 255).astype(np.uint8))
report = sweep_quality.main(["--quick", "--rows", "extract", "--forms", "1", "--device", "cpu"])
print("DIGESTS", json.dumps(out))
''' % (REFUSED,)


def test_runs_without_jax_cv2_or_fonttools():
    """In a process where JAX, the JAX package, cv2 and fontTools do not
    import: the Latin and Devanagari renderers and the form renderer draw
    the JAX record's pixels (the fonts from the package, their coverage
    from their cmap tables), and the extraction sweep runs."""
    from ocr_system_tpu_torch.utils import smoke

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1].split(" ", 1)[1])
    want = smoke.eval_expected()["phases"]
    assert got["latin"] == want["eval_rec"]["float32"]["latin"]["digests"][0]
    assert got["devanagari"] == want["eval_rec"]["float32"]["devanagari"]["digests"][0]
    assert got["form"] == want["eval_e2e_hybrid"]["float32"]["pages"]["digests"][0]
    assert any(ln.startswith("SWEEP ") for ln in proc.stdout.splitlines())
