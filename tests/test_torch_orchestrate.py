"""The port's orchestrator stages against the JAX package's: ``fields_for``
(extract with the table, checkbox and signature merges; the field rows
with their key and value boxes; the validation report) against the JAX
orchestrator's ``_stage_extract``, ``_stage_save`` and ``_stage_validate``
on a temporary sqlite database, on small OCR results built from the
committed smoke forms' records; with the rule extractor, the trained
layout extractor, and a random small one whose degenerate output falls
back to the rules in both packages. And the extractor dispatch."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.engine import pipeline as jax_pipeline
from ocr_system_tpu.extract import layout_model as jax_lm
from ocr_system_tpu.extract.rules import RuleExtractor as JaxRules
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayoutExtractor
from ocr_system_tpu.parallel.sharding import unbox
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import pipeline
from ocr_system_tpu_torch.extract import layout_model
from ocr_system_tpu_torch.extract.rules import RuleExtractor
from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator
from ocr_system_tpu_torch.utils import smoke

from export_torch_weights import jax_fields_for, rounded_bf16

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_, EXPECTED = smoke.smoke_forms()
RECORDS = EXPECTED["pages"]["float32"] + EXPECTED["mixed"]["float32"]


def _documents(pages: list[int], seed: int):
    """The committed records of ``pages`` (indices into RECORDS) as one
    OCR result of each package: every layout box with a seeded confidence
    (the records keep none), the pages numbered from 1."""
    rng = np.random.default_rng(seed)
    outs = {"port": [], "jax": []}
    for n, k in enumerate(pages, 1):
        rec = RECORDS[k]
        boxes = [{"type": typ, **b, "confidence": round(float(rng.uniform(0.4, 1.0)), 4),
                  "page_number": n}
                 for typ in smoke.LAYOUT_TYPES for b in rec[typ]]
        for key, cls in (("port", pipeline.OCROutput), ("jax", jax_pipeline.OCROutput)):
            outs[key].append(cls(success=True, markdown=rec["markdown"],
                                 layout_boxes=[dict(b) for b in boxes], page_number=n,
                                 page_width=960.0, page_height=960.0))
    port = pipeline.document_result(outs["port"])
    ref = jax_pipeline.DocumentOCRResult(
        success=True, pages=outs["jax"], total_pages=len(pages),
        combined_markdown=jax_pipeline.combine_markdown([o.markdown for o in outs["jax"]]))
    assert port.combined_markdown == ref.combined_markdown
    return port, ref


def _port_record(orch, doc, template=None, custom_prompt=None) -> dict:
    result, rows, report = orch.fields_for(doc, template, custom_prompt)
    return {"result": smoke.result_record(result), "rows": smoke.rows_record(rows),
            "report": smoke.report_record(report)}


def _jax_record(extractor, doc, tmp_path, template=None, custom_prompt=None) -> dict:
    return jax_fields_for(JaxSettings(), object(), extractor, doc, tmp_path, template,
                          custom_prompt)


RULE_CASES = [
    ([0], None, None), ([3], None, None), ([8], None, None), ([9, 10], None, None),
    ([1, 2, 3], None, None),
    ([4], {"expected_fields": ["Insurance ID", {"name": "Visit Date", "field_type": "date"}]},
     None),
    ([5], None, "Extract only: Total, Date. Ignore Comments"),
]


@pytest.mark.parametrize("pages,template,prompt", RULE_CASES)
def test_fields_for_with_rules_matches_jax(pages, template, prompt, tmp_path):
    doc, ref = _documents(pages, seed=len(pages) * 10 + pages[0])
    orch = ExtractionOrchestrator(Settings(), engine=object(), extractor=RuleExtractor())
    got = _port_record(orch, doc, template, prompt)
    want = _jax_record(JaxRules(), ref, tmp_path, template, prompt)
    assert got == want
    kinds = {f[2] for f in got["result"]["fields"]}
    assert got["rows"] and got["report"]["total_fields"] == len(got["rows"]), kinds


def test_fields_for_with_the_trained_extractor_matches_jax(tmp_path):
    """Form 4 and a Hindi form as one small document, the trained model at
    float32 (JAX on the rounded weights, the port on weights/extract.npz):
    fields, rows and report equal, table, checkbox and signature merges
    included."""
    doc, ref = _documents([3, 8], seed=21)
    jax_ex = jax_lm.LayoutModelExtractor(JaxSettings(
        extract_checkpoint=str(REPO / "checkpoints/extract"), compute_dtype="float32"))
    jax_ex.variables = rounded_bf16(jax_ex.variables)
    ex = layout_model.get_extractor(Settings(compute_dtype="float32"), device="cpu")
    got = _port_record(ExtractionOrchestrator(Settings(), engine=object(), extractor=ex), doc)
    want = _jax_record(jax_ex, ref, tmp_path)
    assert got == want
    kinds = {f[2] for f in got["result"]["fields"]}
    assert {"table", "signature"} <= kinds, kinds


def _random_pair(tag_o_only: bool = False):
    """A random 64-wide, 2-deep extractor, the same weights in both
    packages; with ``tag_o_only`` its tag head says "O" for every token (a
    zero kernel, a bias that favours O)."""
    vocab = layout_model.get_charset("multilingual").size
    jm = JaxLayoutExtractor(vocab_size=vocab, dim=64, depth=2, max_len=2048)
    z = np.zeros((1, 16), np.int32)
    variables = jax.tree.map(np.asarray, unbox(jax.jit(
        lambda r: jm.init(r, z, np.zeros((1, 16, 4), np.int32), z + 1))(jax.random.PRNGKey(7))))
    if tag_o_only:
        head = variables["params"]["tag_head"]
        head["kernel"] = np.zeros_like(head["kernel"])
        head["bias"] = np.array([1.0, 0, 0, 0, 0], np.float32)
    kw = dict(extract_dim=64, extract_depth=2, compute_dtype="float32")
    jax_ex = jax_lm.LayoutModelExtractor(JaxSettings(**kw), params=variables)
    ex = layout_model.LayoutModelExtractor(
        Settings(**kw), state_dict=weights.layout_state_dict(variables), device="cpu")
    return jax_ex, ex


@pytest.mark.parametrize("pages", [[7], [0], [8], [2, 9]])
def test_random_weights_match_jax(pages, tmp_path):
    """Random weights: the whole stage output is equal, the tier that
    produced the fields (``raw_response``: the model, its lexicon retry or
    the rules) included."""
    doc, ref = _documents(pages, seed=31)
    jax_ex, ex = _random_pair()
    got = _port_record(ExtractionOrchestrator(Settings(), engine=object(), extractor=ex), doc)
    assert got == _jax_record(jax_ex, ref, tmp_path)


@pytest.mark.parametrize("pages", [[7], [3]])
def test_degenerate_output_falls_back_to_rules_in_both(pages, tmp_path):
    """Random weights whose tag head tags every token O: on a Latin page no
    field decodes (on a Hindi page the structural inline split still
    would), the lexicon retry finds no complete pair, and both packages
    serve the rule tier's fields (``layout_model:degenerate->rules``)."""
    doc, ref = _documents(pages, seed=32)
    jax_ex, ex = _random_pair(tag_o_only=True)
    got = _port_record(ExtractionOrchestrator(Settings(), engine=object(), extractor=ex), doc)
    assert got["result"]["raw_response"] == "layout_model:degenerate->rules"
    assert got == _jax_record(jax_ex, ref, tmp_path)


def test_get_extractor_dispatch(tmp_path):
    missing = str(tmp_path / "none.npz")
    assert isinstance(layout_model.get_extractor(
        Settings(extract_checkpoint=missing), device="cpu"), RuleExtractor)
    assert isinstance(layout_model.get_extractor(
        Settings(extraction_method="rules"), device="cpu"), RuleExtractor)
    with pytest.raises(FileNotFoundError):
        layout_model.get_extractor(
            Settings(extraction_method="layout_model", extract_checkpoint=missing), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            layout_model.get_extractor(Settings())
    ex = layout_model.get_extractor(Settings(extraction_method="layout_model"), device="cpu")
    assert isinstance(ex, layout_model.LayoutModelExtractor) and ex.device.type == "cpu"
    assert ex.settings.extract_checkpoint == ""  # the default path, as "auto" resolves it


def test_orchestrator_builds_its_defaults_on_the_device():
    """With no engine or extractor, the orchestrator builds the served
    engine and extractor on the device it is given."""
    orch = ExtractionOrchestrator(Settings(det_image_buckets=(256,), compute_dtype="float32"),
                                  device="cpu")
    assert isinstance(orch.extractor, layout_model.LayoutModelExtractor)
    assert orch.extractor.device.type == "cpu"
    assert orch.engine.recognizer.device.type == "cpu"
