"""The port's quality evaluation (training/evaluate.py,
training/synth_forms_heldout.py) against the JAX package's on the same
inputs and weights at float32: the CER helpers on generated strings,
``_cluster_rows``, the held-out form generator, the form and field
extraction evaluations with the rule extractor (equal) and the trained
512 x 8 model (every rate within 1e-6), the recognizer evaluation with
both trained recognizers, and the engine evaluations (end to end, form
extraction through the engine, signatures) with the trained hybrid engine
at a small bucket (every item's output equal, every CER and rate within
1e-9: the same texts give the same numbers). Each evaluation runs through
utils/smoke.Recorder, which also proves that the port renders the same
lines and pages as the JAX package here (the committed record of the
JAX evaluation: tests/test_torch_eval_record.py)."""

import dataclasses
import random
import string

import numpy as np
import pytest
import torch
from hypothesis import given, settings as hyp_settings, strategies as st

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.hybrid_detector import HybridDetector as JaxHybrid
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.recognizer import Recognizer as JaxRecognizer
from ocr_system_tpu.extract import layout_model as jax_lm
from ocr_system_tpu.extract.rules import RuleExtractor as JaxRules
from ocr_system_tpu.models.charsets import get_charset as jax_charset
from ocr_system_tpu.training import evaluate as JE
from ocr_system_tpu.training import synth as JS
from ocr_system_tpu.training import synth_forms_heldout as JH
from ocr_system_tpu.training.devanagari_font import ensure_font
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
from ocr_system_tpu_torch.extract.rules import RuleExtractor
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.training import evaluate as E
from ocr_system_tpu_torch.training import synth_forms_heldout as H
from ocr_system_tpu_torch.training.run_evaluate import build_engine
from ocr_system_tpu_torch.utils import smoke
from ocr_system_tpu_torch.utils.smoke import Recorder

from export_torch_weights import rounded_bf16

torch.set_num_threads(1)
# the JAX renderer lists its Devanagari font once it exists, as the port
# always lists its own
ensure_font()

LATIN = string.ascii_letters + string.digits + " .,:-/"
DEVANAGARI = "कखगघचजटडतदनपबमयरलवसह ािीुूेैोंः्।०१२ .:"
RATE_TOL = 1e-6
EXACT_TOL = 1e-9
SIZE = 384  # pages and the detection bucket of the engine evaluations


def _plain(result) -> dict:
    return dataclasses.asdict(result) if dataclasses.is_dataclass(result) else result


def _close(got, want, tol: float) -> None:
    """Every number of two results within ``tol``, the rest equal."""
    got, want = _plain(got), _plain(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, tol)
        elif isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=tol), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("alphabet", [LATIN, DEVANAGARI], ids=["latin", "devanagari"])
@hyp_settings(max_examples=150, deadline=None)
@given(data=st.data())
def test_cer_helpers_match_jax(alphabet, data):
    """edit_distance, cer and infix_cer (the numpy rows) give the JAX
    package's integers and ratios."""
    a = data.draw(st.text(alphabet=alphabet, max_size=40))
    b = data.draw(st.text(alphabet=alphabet, max_size=40))
    assert E.edit_distance(a, b) == JE.edit_distance(a, b)
    assert E.cer(a, b) == JE.cer(a, b)
    assert E.infix_cer(a, b) == JE.infix_cer(a, b)


def test_cer_on_whole_pages_matches_jax():
    """Page-length strings (the page CER's case)."""
    r = random.Random(3)
    for alphabet, n in ((LATIN, 700), (DEVANAGARI, 400)):
        a = "".join(r.choice(alphabet) for _ in range(n))
        b = "".join(c if r.random() > 0.1 else r.choice(alphabet) for c in a[: n - 37])
        assert E.edit_distance(a, b) == JE.edit_distance(a, b)
        assert E.infix_cer(b[100:180], a) == JE.infix_cer(b[100:180], a)


@pytest.mark.parametrize("seed", range(3))
def test_cluster_rows_matches_jax(seed):
    """A rendered page's word quads and texts, and random boxes."""
    page = JS.TextRenderer(jax_charset("latin"), seed=seed).render_page(size=256, augment=False)
    assert E._cluster_rows(page.quads, page.texts) == JE._cluster_rows(page.quads, page.texts)
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (40, 1, 2))
    quads = (xy + np.array([[0, 0], [30, 0], [30, 12], [0, 12]]) * rng.uniform(
        0.5, 2.0, (40, 1, 1))).astype(np.float32)
    texts = [f"w{i}" for i in range(40)]
    assert E._cluster_rows(quads, texts) == JE._cluster_rows(quads, texts)


@pytest.mark.parametrize("seed", [0, 1, 101, 1110, 4242])
def test_heldout_specs_equal_jax(seed):
    """HeldoutFormGenerator: 4 specs per seed equal field by field."""
    a, b = H.HeldoutFormGenerator(seed=seed), JH.HeldoutFormGenerator(seed=seed)
    assert H.HELDOUT_TYPE_NAMES == JH.HELDOUT_TYPE_NAMES
    for size in (640, 960, 800, 1280):
        assert dataclasses.asdict(a.generate(size)) == dataclasses.asdict(b.generate(size))


def _both(fn_port, fn_jax, port_obj, jax_obj, **kw):
    """One evaluation through each package's function, each on a Recorder:
    (port record, JAX record)."""
    got, want = Recorder(port_obj), Recorder(jax_obj)
    return got.record(fn_port(got, **kw)), want.record(fn_jax(want, **kw))


@pytest.mark.parametrize("family", ["infamily", "heldout"])
def test_form_extraction_with_rules_equals_jax(family):
    kw = {"n_docs": 6, "seed": 77}
    gens = ((H.HeldoutFormGenerator(seed=5), JH.HeldoutFormGenerator(seed=5))
            if family == "heldout" else (None, None))
    got, want = Recorder(RuleExtractor()), Recorder(JaxRules())
    a = E.evaluate_form_extraction(got, generator=gens[0], **kw)
    b = JE.evaluate_form_extraction(want, generator=gens[1], **kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert got.items == want.items and len(got.items) == 6


def test_field_extraction_with_rules_equals_jax():
    got, want = _both(E.evaluate_field_extraction, JE.evaluate_field_extraction,
                      RuleExtractor(), JaxRules(), n_docs=12, seed=5)
    assert got == want


@pytest.fixture(scope="module")
def extractors():
    """The trained 512 x 8 extractor at float32: the port's on
    weights/extract.npz, the JAX package's on checkpoints/extract rounded
    as that file is (export_torch_weights.rounded_bf16)."""
    ref = jax_lm.LayoutModelExtractor(JaxSettings(extract_checkpoint="checkpoints/extract",
                                                  compute_dtype="float32"))
    ref.variables = rounded_bf16(ref.variables)
    return LayoutModelExtractor(Settings(compute_dtype="float32"), device="cpu"), ref


@pytest.mark.parametrize("family", ["infamily", "heldout"])
def test_form_extraction_with_the_trained_model_matches_jax(family, extractors):
    """4 noisy forms: the same fields per document, every rate within 1e-6."""
    gens = ((H.HeldoutFormGenerator(seed=101), JH.HeldoutFormGenerator(seed=101))
            if family == "heldout" else (None, None))
    got, want = Recorder(extractors[0]), Recorder(extractors[1])
    a = E.evaluate_form_extraction(got, n_docs=4, generator=gens[0])
    b = JE.evaluate_form_extraction(want, n_docs=4, generator=gens[1])
    _close(a, b, RATE_TOL)
    assert got.items == want.items


@pytest.mark.parametrize("cs", ["latin", "devanagari"])
def test_recognizer_eval_matches_jax(cs):
    """10 held-out lines through each trained recognizer: the same pixels,
    texts and scores."""
    ckpt = {"latin": "rec_latin", "devanagari": "rec_devanagari"}[cs]
    port = Recognizer(Settings(rec_checkpoint=str(smoke.PACKAGE / "weights" / f"{ckpt}.npz"),
                               compute_dtype="float32", rec_width_buckets=(320,)),
                      charset=get_charset(cs), device="cpu")
    ref = JaxRecognizer(JaxSettings(rec_checkpoint=f"checkpoints/{ckpt}", compute_dtype="float32",
                                    rec_width_buckets=(320,)), charset=jax_charset(cs))
    got, want = Recorder(port), Recorder(ref)
    a = E.evaluate_recognizer(got, get_charset(cs), n_lines=10, seed=9999)
    with mesh_context(build_mesh("dp=1")):
        b = JE.evaluate_recognizer(want, jax_charset(cs), n_lines=10, seed=9999)
    assert got.digests == want.digests
    assert got.items == want.items
    _close(a, b, EXACT_TOL)


@pytest.fixture(scope="module")
def engines():
    """The trained hybrid engine as the sweep builds it, float32, at a small
    bucket: the port's and the JAX package's."""
    kw = dict(det_image_buckets=(SIZE,), rec_width_buckets=(80, 160, 320),
              det_prob_wire_bits=4, compute_dtype="float32", storage_root="storage")
    s = Settings(**smoke.TRAINED, **kw)
    js = JaxSettings(det_checkpoint="checkpoints/det", rec_checkpoint="checkpoints/rec_latin",
                     rec_checkpoint_devanagari="checkpoints/rec_devanagari", **kw)
    port = build_engine("hybrid", s, get_charset("latin"), "cpu")
    ref = JaxOCREngine(js, detector=JaxHybrid(js),
                       recognizer=JaxRecognizer(js, charset=jax_charset("latin")))
    return port, ref


def _engine_eval(port_fn, jax_fn, engines, *args, **kw):
    got, want = Recorder(engines[0]), Recorder(engines[1])
    a = port_fn(got, *args[:1], **kw)
    with mesh_context(build_mesh("dp=1")):
        b = jax_fn(want, *args[1:], **kw)
    assert got.digests == want.digests and got.digests
    return got, want, a, b


def test_end_to_end_matches_jax(engines):
    """Two pages, one form and one plain page: the same pixels, the same
    markdown and handwriting per page, the same scores."""
    got, want, a, b = _engine_eval(E.evaluate_end_to_end, JE.evaluate_end_to_end, engines,
                                   get_charset("latin"), jax_charset("latin"),
                                   n_pages=2, size=SIZE, seed=5555)
    assert [smoke.same_item(x, y) for x, y in zip(got.items, want.items)] == [True, True]
    _close(a, b, EXACT_TOL)
    assert a.forms_page_cer >= 0 and a.plain_page_cer >= 0


def test_signature_detection_matches_jax(engines):
    got, want, a, b = _engine_eval(E.evaluate_signature_detection,
                                   JE.evaluate_signature_detection, engines,
                                   n_docs=2, page_size=SIZE)
    assert all(smoke.same_item(x, y) for x, y in zip(got.items, want.items, strict=True))
    _close(a, b, EXACT_TOL)


def test_form_extraction_e2e_matches_jax(engines, extractors):
    """One form through the engine, then the trained extractor."""
    got, want = Recorder(engines[0]), Recorder(engines[1])
    gx, wx = Recorder(extractors[0]), Recorder(extractors[1])
    a = E.evaluate_form_extraction_e2e(got, gx, n_docs=1, page_size=SIZE)
    with mesh_context(build_mesh("dp=1")):
        b = JE.evaluate_form_extraction_e2e(want, wx, n_docs=1, page_size=SIZE)
    assert got.digests == want.digests
    assert smoke.same_item(got.items[0], want.items[0]) and gx.items == wx.items
    _close(a, b, EXACT_TOL)


def test_truth_charset_follows_the_routing_recognizer(tmp_path):
    """The union charset exactly where the engine routes to a Devanagari
    recognizer: rec_charset "auto" and its weights present."""
    class Engine:
        def __init__(self, **kw):
            self.settings = Settings(**kw)

    latin = get_charset("latin")
    deva = str(smoke.PACKAGE / "weights" / "rec_devanagari.npz")
    assert E._truth_charset(Engine(rec_checkpoint_devanagari=deva), latin).name == "multilingual"
    assert E._truth_charset(Engine(rec_checkpoint_devanagari=deva, rec_charset="latin"),
                            latin) is latin
    assert E._truth_charset(Engine(checkpoint_dir=str(tmp_path)), latin) is latin
    assert E._truth_charset(object(), latin) is latin
