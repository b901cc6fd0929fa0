"""The port's Settings against the JAX package's: same fields, defaults and
environment names (minus mesh_shape), same .env and environment parsing."""

import dataclasses

import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu_torch.core.config import Settings

torch.set_num_threads(1)

PORT_FIELDS = {f.name: f for f in dataclasses.fields(Settings)}


def test_same_fields_and_defaults():
    jax_fields = dict(JaxSettings.model_fields)
    assert jax_fields.pop("mesh_shape")
    assert set(PORT_FIELDS) == set(jax_fields)
    jax_defaults = JaxSettings()
    port_defaults = Settings()
    for name in PORT_FIELDS:
        assert getattr(port_defaults, name) == getattr(jax_defaults, name), name


ENV_CASES = [
    ("DET_WIRE_BITS", "8"),  # int
    ("DET_BIN_THRESH", "0.25"),  # float
    ("DET_BOX_PAD_RATIO_Y", "0.4"),  # optional float
    ("ENABLE_DESKEW", "false"),  # bool
    ("DET_GLUE_SPLIT", "0"),
    ("WARMUP_ON_START", "yes"),
    ("DET_IMAGE_BUCKETS", "640,960"),  # tuple of ints
    ("ALLOWED_EXTENSIONS", "png,pdf"),  # tuple of strings
    ("COMPUTE_DTYPE", "float32"),  # str
]


@pytest.mark.parametrize("name,value", ENV_CASES)
def test_environment_parses_like_jax(monkeypatch, tmp_path, name, value):
    monkeypatch.setenv(name, value)
    field = name.lower()
    missing = tmp_path / "none.env"
    assert (getattr(Settings.from_env(missing), field)
            == getattr(JaxSettings.from_env(missing), field))


def test_env_file_parses_like_jax(monkeypatch, tmp_path):
    for name, _ in ENV_CASES:
        monkeypatch.delenv(name, raising=False)
    env = tmp_path / ".env"
    env.write_text("# comment\n\n" + "\n".join(
        f"{n.lower()}='{v}'" for n, v in ENV_CASES) + "\nUNKNOWN_KEY=1\n")
    port, ref = Settings.from_env(env), JaxSettings.from_env(env)
    for name, _ in ENV_CASES:
        assert getattr(port, name.lower()) == getattr(ref, name.lower())


def test_model_copy():
    s = Settings().model_copy(update={"det_wire_bits": 8})
    assert s.det_wire_bits == 8 and Settings().det_wire_bits == 4


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    """Without a card and without device="cpu" the engine raises."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchOCREngine(Settings())


# the detector options the port does not run yet
UNPORTED_DET = [
    {"det_wire_bits": 2},
    {"det_wire_bits": 8},
    {"enable_contrast_enhancement": False},
    {"det_prob_wire_bits": 4},
    {"enable_adaptive_binarization": True},
]


def test_engine_refuses_settings_outside_the_slice():
    """What the port does not run yet is the detector's options: the engine
    refuses each through its detector."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine

    for update in UNPORTED_DET:
        with pytest.raises(ValueError, match="port"):
            TorchOCREngine(Settings(**update), device="cpu")


@pytest.mark.parametrize("update", UNPORTED_DET)
def test_detector_refuses_unported_det_settings(update):
    """The detector runs only the served wire format and preprocessing;
    other values raise before any weights are built."""
    from ocr_system_tpu_torch.engine.detector import Detector

    with pytest.raises(ValueError, match="port"):
        Detector(Settings(**update), device="cpu")


def test_engine_accepts_every_serving_default_but_script_routing():
    """The serving defaults build as they are, script routing now included
    (the name is kept from when it was not), and so do the two options of
    engine/script.py."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine

    s = Settings()
    assert (s.ocr_engine, s.rec_charset, s.enable_selection_marks,
            s.enable_handwriting_detection, s.det_glue_split) == (
        "hybrid", "auto", True, True, True)
    TorchOCREngine(s, device="cpu")
    for key in ("det_split_column_gaps", "rec_tighten_y"):
        TorchOCREngine(Settings(**{key: True}), device="cpu")


@pytest.mark.parametrize("charset", ["auto", "latin", "devanagari", "multilingual"])
def test_every_rec_charset_runs_a_page(charset):
    """Each rec_charset the JAX engine takes runs a page on the CPU (random
    weights; "auto" with the exported Devanagari weights routes), with
    det_split_column_gaps and rec_tighten_y on."""
    from pathlib import Path

    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils.smoke import draw_page

    deva = Path(__file__).resolve().parents[1] / "ocr_system_tpu_torch/weights/rec_devanagari.npz"
    s = Settings(rec_charset=charset, det_image_buckets=(128,), rec_width_buckets=(80,),
                 det_split_column_gaps=True, rec_tighten_y=True,
                 rec_checkpoint_devanagari=str(deva))
    eng = TorchOCREngine(s, device="cpu")
    assert (eng.devanagari is not None) == (charset == "auto")
    page = draw_page(np.random.default_rng(3), 128, 128)
    out = eng.process_pages([PageImage(page, 1)])[0]
    assert out.success and out.page_width == 128
    assert [set(r.values()) <= {eng.recognizer.charset.name, "devanagari"}
            for r in eng.routed] == [True]


def test_get_engine_builds_each_engine_once():
    """"jax", "classical" and "hybrid" get their detectors; concurrent first
    calls with one configuration build one engine; another configuration
    gets its own."""
    from concurrent.futures import ThreadPoolExecutor

    from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
    from ocr_system_tpu_torch.engine.detector import Detector
    from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector
    from ocr_system_tpu_torch.engine.pipeline import get_engine

    small = dict(det_image_buckets=(64,), rec_width_buckets=(80,))
    for name, kind in (("jax", Detector), ("classical", ClassicalDetector),
                       ("hybrid", HybridDetector)):
        s = Settings(ocr_engine=name, **small)
        with ThreadPoolExecutor(4) as ex:
            engines = list(ex.map(lambda _: get_engine(s, device="cpu"), range(4)))
        assert all(e is engines[0] for e in engines)
        assert type(engines[0].detector) is kind
    other = get_engine(Settings(ocr_engine="hybrid", compute_dtype="float32", **small),
                       device="cpu")
    assert other is not get_engine(Settings(ocr_engine="hybrid", **small), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        get_engine(Settings(ocr_engine="fake", **small), device="cpu")
