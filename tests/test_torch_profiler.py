"""The port's device tracing and det/rec breakdown (utils/profiler.py)
against the JAX package's: ``device_trace`` writes a trace with events on
the CPU when asked for the CPU and raises without a card otherwise;
``peak_flops`` knows the H100 and refuses any other card;
``det_rec_breakdown`` on the JAX engine and on the port's engine with the
same (trained) weights on the same page, at the sizes of the JAX test's
``settings`` fixture: the same ``wave_pages`` and wall keys, no device key
from the CPU, and the port's det and rec FLOPs equal to a closed-form count
from the modules' convolution and dense shapes and SVTR's attention
products (exact: both are integer counts). XLA's ``cost_analysis`` figure
for the same work is printed beside it (``-s``): it counts elementwise work
too, which ``FlopCounterMode`` does not."""

import json
import types

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage
from ocr_system_tpu.training import synth_forms
from ocr_system_tpu.utils import profiler as jax_profiler
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.models.layers import ConvTranspose2x2, Dense
from ocr_system_tpu_torch.models.recognizer import MixerBlock
from ocr_system_tpu_torch.utils import profiler

torch.set_num_threads(1)

# the JAX test's settings fixture (tests/conftest.py) at its sizes, on the
# neural engine with Latin recognition and the trained checkpoints, so the
# page has words to recognize
SMALL = dict(
    det_image_buckets=(256,),
    rec_width_buckets=(80, 160),
    rec_batch_size=8,
    enable_deskew=False,
    ocr_engine="jax",
    rec_charset="latin",
    enable_selection_marks=False,
    enable_handwriting_detection=False,
    det_glue_split=False,
)
WALL_KEYS = ("det_wall", "rec_wall")
DEVICE_KEYS = ("det_device", "det_device_total", "det_mfu", "det_compute_pages_per_s",
               "rec_device", "rec_device_total", "rec_mfu", "compute_pages_per_s")


def test_device_trace_on_the_cpu_writes_events(tmp_path):
    with profiler.device_trace(tmp_path, device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.events()


def test_without_a_card_trace_and_breakdown_raise(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError):
        with profiler.device_trace(tmp_path / "t"):
            pass
    assert not (tmp_path / "t").exists()
    engine = types.SimpleNamespace(recognizer=types.SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(RuntimeError):
        profiler.det_rec_breakdown(engine, [])


def test_peak_flops(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert profiler.peak_flops("cuda", torch.bfloat16) == 989e12
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    assert profiler.peak_flops("cuda:0", torch.float32) == 67e12
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert profiler.peak_flops("cuda:0", torch.float32) == 495e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        profiler.peak_flops("cuda", torch.bfloat16)
    with pytest.raises(ValueError):
        profiler.peak_flops("cpu", torch.float32)


def closed_form_flops(model: torch.nn.Module, run) -> int:
    """2 x the multiply-adds of one call of ``run``, counted from shapes:
    each convolution from its weight and output (a transposed one from its
    input), each dense layer from its output and in_features, each SVTR
    block's two attention products (QK^T and AV: 2 x 2 B T^2 D), and the
    CTC head, an F.linear on the final norm's output."""
    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out.numel() * int(np.prod(m.weight.shape[1:]))

    def conv_t(m, inp, out):
        total[0] += 2 * inp[0].numel() * int(np.prod(m.weight.shape[1:]))

    def dense(m, inp, out):
        total[0] += 2 * out.numel() * m.in_features

    def attention(m, inp, out):
        b, t, d = inp[0].shape
        total[0] += 2 * 2 * b * t * t * d

    def head(m, inp, out):
        total[0] += 2 * out.numel() * model.head.out_features

    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, ConvTranspose2x2):
            hooks.append(m.register_forward_hook(conv_t))
        elif isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, Dense):
            hooks.append(m.register_forward_hook(dense))
        elif isinstance(m, MixerBlock):
            hooks.append(m.register_forward_hook(attention))
        elif name == "norm" and hasattr(model, "head"):
            hooks.append(m.register_forward_hook(head))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


@pytest.fixture(scope="module")
def engines():
    gen = synth_forms.FormGenerator(seed=3)
    page = (np.asarray(synth_forms.render_spec(gen.generate(256)).image) * 255
            ).round().astype(np.uint8)
    jax_eng = JaxOCREngine(JaxSettings(**SMALL, det_checkpoint="checkpoints/det",
                                       rec_checkpoint="checkpoints/rec_latin"))
    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    s = Settings(**SMALL)
    eng = TorchOCREngine(
        s,
        detector=Detector(s, weights.dbnet_state_dict(tree(jax_eng.detector.variables)),
                          device="cpu"),
        recognizer=Recognizer(s, weights.svtr_state_dict(tree(jax_eng.recognizer.variables)),
                              device="cpu"),
        device="cpu",
    )
    return page, jax_eng, eng


def _xla_flops(jax_eng, page) -> tuple[float, float]:
    """XLA's cost_analysis FLOPs of the JAX wave's det forward and its rec
    dispatches (what the JAX breakdown divides by device time)."""
    pages = [JaxPageImage(page, 1)]
    dets = jax_eng.det_stage(pages)
    det = jax_eng.detector
    canvas = np.asarray(dets[0].canvas_stack)
    x = jax.device_put(det._pack_wire(canvas))
    fwd = det._forward(canvas.shape[1], canvas.shape[0])

    def flops(fn, *args):
        cost = fn.lower(*args).compile().cost_analysis()
        return float((cost[0] if isinstance(cost, list) else cost).get("flops", 0.0))

    stash = []
    jax_eng.recognizer._profile_stash = stash
    try:
        jax_eng.rec_stage(pages, dets)
    finally:
        jax_eng.recognizer._profile_stash = None
    return flops(fwd, x, det.variables), sum(flops(run, *args) for run, args in stash)


def test_breakdown_matches_jax_and_the_closed_form(engines, capsys):
    page, jax_eng, eng = engines
    with mesh_context(build_mesh("dp=1")):
        want = jax_profiler.det_rec_breakdown(jax_eng, [JaxPageImage(page, 1)])
        xla_det, xla_rec = _xla_flops(jax_eng, page)
    got = profiler.det_rec_breakdown(eng, [PageImage(page, 1)])
    assert got["wave_pages"] == want["wave_pages"] == 1
    for key in WALL_KEYS:
        assert got[key] > 0 and want[key] > 0
    # the CPU is no device: no device time, MFU or compute throughput
    assert not set(DEVICE_KEYS) & set(got)
    assert got["device"] == "cpu" and got["power_limit_w"] is None
    assert "mfu_error" not in got

    # the same det forward and rec dispatches, counted from shapes
    det = eng.detector
    dets = eng.det_stage([PageImage(page, 1)])
    x = torch.from_numpy(det._pack_wire(dets[0].canvas_stack.numpy()))
    det_cf = closed_form_flops(det.model, lambda: det._forward_device(x, det.model))
    stash = []
    eng.recognizer._profile_stash = stash
    try:
        eng.rec_stage([PageImage(page, 1)], dets)
    finally:
        eng.recognizer._profile_stash = None
    assert stash, "the page has words: the recognizer must dispatch"
    rec_cf = closed_form_flops(eng.recognizer.model, lambda: [run() for run in stash])
    assert got["det_flops"] == det_cf > 0
    assert got["rec_flops"] == rec_cf > 0
    assert got["det_wave_tflops"] == round(det_cf / 1e12, 3)
    assert got["rec_wave_tflops"] == round(rec_cf / 1e12, 3)

    with capsys.disabled():
        print(f"\nFLOPs det: port {det_cf} (closed form {det_cf}), XLA cost_analysis {xla_det:.0f}"
              f" ({xla_det / det_cf:.3f}x); rec: port {rec_cf}, XLA {xla_rec:.0f}"
              f" ({xla_rec / rec_cf:.3f}x); JAX breakdown keys {sorted(want)}")


def test_breakdown_stash_is_inert_and_released(engines):
    """The stash hook is off outside the breakdown: a served wave stashes
    nothing, and the breakdown leaves every recognizer's hook off."""
    page, _, eng = engines
    assert eng.recognizer._profile_stash is None
    eng.process_pages([PageImage(page, 1)])
    assert eng.recognizer._profile_stash is None
    profiler.det_rec_breakdown(eng, [PageImage(page, 1)])
    assert eng.recognizer._profile_stash is None
