"""The deskew turn on the CPU: the rotate kernel's wrapper runs its plain
version (``host_image.rotate_cubic``) on CPU tensors and launches nothing;
a CPU engine's detector turns its skewed pages on the host exactly as the
per-page loop it replaced did, and counts no ``turn.card_pages``; the
classical pass of the hybrid detector turns on the neural detector's
device, inside a ``classical.turn`` span under ``det_classical``, beside
its ``classical.skew`` and ``classical.mask`` spans. The
kernel itself is held against ``rotate_cubic`` bit for bit on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import classical_detector
from ocr_system_tpu_torch.engine import detector as detector_mod
from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.host_image import rotate_cubic, rotation_params
from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector
from ocr_system_tpu_torch.kernels import rotate
from ocr_system_tpu_torch.training import synth_forms
from ocr_system_tpu_torch.utils.profiler import SPANS
from ocr_system_tpu_torch.utils.smoke import TRAINED

torch.set_num_threads(1)

TURN_DEG = 3.0
DET = {**TRAINED, "det_image_buckets": (256,), "enable_deskew": True, "rec_charset": "latin",
       "det_batch_size": 2}


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def pages():
    """Three forms at the bucket's size, the second turned by 3 degrees."""
    gen = synth_forms.FormGenerator(seed=3)
    out = [(np.asarray(synth_forms.render_spec(gen.generate(256)).image) * 255
            ).round().astype(np.uint8) for _ in range(3)]
    out[1] = rotate_cubic(out[1], TURN_DEG, fill=255)
    return out


@pytest.fixture(scope="module")
def det():
    return Detector(Settings(**DET), device="cpu")


def _by_id(spans):
    return {s.id: s for s in spans}


def _ancestors(s, by_id):
    while s.parent in by_id:
        s = by_id[s.parent]
        yield s


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
@pytest.mark.parametrize("fill", [255, 0])
def test_wrapper_runs_rotate_cubic_on_cpu_tensors(shape, channels, fill):
    rng = np.random.default_rng(5)
    pages = rng.integers(0, 256, (4, *shape, channels), np.uint8)
    angles = [0.5, -1.999999, 4.0, -45.0]
    before = rotate.LAUNCHES.value
    got = rotate.rotate_pages(torch.from_numpy(pages), angles, fill)
    assert got.dtype == torch.uint8 and got.shape == pages.shape
    for page, angle, out in zip(pages, angles, got):
        assert np.array_equal(out.numpy(), rotate_cubic(page, angle, fill))
    assert rotate.LAUNCHES.value == before


@pytest.mark.parametrize("angle", [0.5, -4.0, 45.0])
def test_rotation_params_fix_the_centre(angle):
    """The inverse map the kernel and rotate_cubic sample with takes the
    page's centre to itself and turns by the angle; at 0 degrees the turn
    is the identity, bit for bit."""
    h, w = 37, 53
    alpha, beta, tx, ty = rotation_params(h, w, angle)
    assert (alpha, beta) == (np.cos(np.radians(angle)), np.sin(np.radians(angle)))
    cx, cy = w / 2, h / 2
    sx = alpha * (cx - tx) - beta * (cy - ty)
    sy = beta * (cx - tx) + alpha * (cy - ty)
    assert sx == pytest.approx(cx, abs=1e-12) and sy == pytest.approx(cy, abs=1e-12)
    assert rotation_params(h, w, 0.0) == (1.0, 0.0, 0.0, 0.0)
    page = np.random.default_rng(2).integers(0, 256, (h, w, 3), np.uint8)
    assert np.array_equal(rotate_cubic(page, 0.0), page)


def test_turn_stacks_are_c_ordered_groups_by_shape():
    """What a card's turn uploads: one C-ordered (n, H, W, C) u8 stack per
    page shape, in order of first appearance, from pages of any strides
    (a planar page's channel-last view, a gray page)."""
    rng = np.random.default_rng(4)
    planar = rng.integers(0, 256, (3, 20, 30), np.uint8).transpose(1, 2, 0)
    assert not planar.flags["C_CONTIGUOUS"]
    pages = [planar, rng.integers(0, 256, (12, 9, 3), np.uint8), planar[::-1],
             rng.integers(0, 256, (12, 9), np.uint8)]
    groups = detector_mod._stacks_by_shape(pages)
    assert [ks for ks, _ in groups] == [[0, 2], [1], [3]]
    for ks, stack in groups:
        assert stack.dtype == np.uint8 and stack.flags["C_CONTIGUOUS"] and stack.ndim == 4
        for row, k in enumerate(ks):
            assert np.array_equal(stack[row].reshape(pages[k].shape), pages[k])


def test_cpu_detector_turns_as_the_per_page_loop_did(det, pages, monkeypatch):
    """The CPU engine's turn is today's: each skewed page through
    rotate_cubic on its own, the kernel wrapper never reached; the turned
    page and every box equal those of the per-page loop."""
    def refuse(*a, **k):
        raise AssertionError("a CPU engine reached the rotate kernel's wrapper")

    before = rotate.LAUNCHES.value
    monkeypatch.setattr(detector_mod, "rotate_pages", refuse)
    got = det.detect_batch(pages)
    monkeypatch.setattr(detector_mod, "turn_pages", lambda ps, angles, device: [
        rotate_cubic(p, a, fill=255) for p, a in zip(ps, angles)])
    want = det.detect_batch(pages)
    assert rotate.LAUNCHES.value == before
    assert [r.skew_angle != 0 for r in got] == [False, True, False]
    assert np.array_equal(got[1].page, rotate_cubic(pages[1], got[1].skew_angle, fill=255))
    for g, w in zip(got, want, strict=True):
        assert g.skew_angle == w.skew_angle
        assert np.array_equal(g.page, w.page)
        assert len(g.boxes) == len(w.boxes) > 0
        for a, b in zip(g.boxes, w.boxes):
            assert np.array_equal(a.quad, b.quad) and a.score == b.score


def test_cpu_detector_counts_no_card_pages(det, pages):
    SPANS.clear()
    with cpu_profile():
        det.detect_batch(pages)
    spans = list(SPANS.spans)
    (turn,) = [s for s in spans if s.name == "det.turn"]
    assert "turn.card_pages" not in turn.counts
    assert not any("turn.card_pages" in s.counts for s in spans)


def test_hybrid_classical_pass_turns_on_the_neural_device(pages, monkeypatch):
    """The classical pass re-turns a page it finds skewed (forced here at
    2 degrees) on the neural detector's device; a bare ClassicalDetector
    turns on the host."""
    assert ClassicalDetector().device is None
    hybrid = HybridDetector(Settings(**DET, ocr_engine="hybrid"), device="cpu")
    assert hybrid.classical.device == hybrid.neural.device == torch.device("cpu")
    monkeypatch.setattr(classical_detector, "_estimate_skew_host", lambda page: 2.0)
    (out,) = hybrid.classical.detect_batch(pages[:1])
    assert out.skew_angle == 2.0
    assert np.array_equal(out.page, rotate_cubic(pages[0], 2.0, fill=255))


def test_hybrid_detect_batch_records_the_classical_turn(pages, monkeypatch):
    """Each classical re-turn is a ``classical.turn`` span under
    ``det_classical``, outside ``det_neural``, and counts no card pages on
    a CPU engine."""
    hybrid = HybridDetector(Settings(**DET, ocr_engine="hybrid"), device="cpu")
    monkeypatch.setattr(classical_detector, "_estimate_skew_host", lambda page: -1.5)
    SPANS.clear()
    with cpu_profile():
        res = hybrid.detect_batch(pages[:2])
    spans = list(SPANS.spans)
    by_id = _by_id(spans)
    (classical,) = [s for s in spans if s.name == "det_classical"]
    turns = [s for s in spans if s.name == "classical.turn"]
    assert len(turns) == 2 and all(s.parent == classical.id for s in turns)
    assert all(a.name != "det_neural" for s in turns for a in _ancestors(s, by_id))
    assert not any("turn.card_pages" in s.counts for s in spans)
    # the hybrid result keeps the neural pass's page
    assert len(res) == 2 and res[0].skew_angle == 0.0


def test_hybrid_detect_batch_records_the_classical_skew_and_mask(pages):
    """The classical pass's skew search and ink mask are a ``classical.skew``
    and a ``classical.mask`` span a page under ``det_classical``, outside
    ``det_neural``; each skew span counts its page, and once the phase
    table is built no span counts a build."""
    hybrid = HybridDetector(Settings(**DET, ocr_engine="hybrid"), device="cpu")
    hybrid.detect_batch(pages[:1])
    SPANS.clear()
    with cpu_profile():
        hybrid.detect_batch(pages)
    spans = list(SPANS.spans)
    by_id = _by_id(spans)
    (classical,) = [s for s in spans if s.name == "det_classical"]
    for name in ("classical.skew", "classical.mask"):
        got = [s for s in spans if s.name == name]
        assert len(got) == len(pages) and all(s.parent == classical.id for s in got)
        assert all(a.name != "det_neural" for s in got for a in _ancestors(s, by_id))
    skews = [s for s in spans if s.name == "classical.skew"]
    assert [s.counts for s in skews] == [{"skew.pages": 1}] * len(pages)
    assert not any("skew.table_builds" in s.counts for s in spans)
