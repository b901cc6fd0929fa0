"""The port's Settings against the JAX package's: same fields, defaults and
environment names (minus mesh_shape), same .env and environment parsing."""

import dataclasses

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
    from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS, TorchOCREngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchOCREngine(Settings(**SLICE_SETTINGS))


def test_engine_refuses_settings_outside_the_slice():
    from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS, TorchOCREngine

    with pytest.raises(ValueError, match="not ported yet"):
        TorchOCREngine(Settings(**{**SLICE_SETTINGS, "rec_charset": "auto"}), device="cpu")


@pytest.mark.parametrize("update", [
    {"det_wire_bits": 2},
    {"det_wire_bits": 8},
    {"enable_contrast_enhancement": False},
    {"det_prob_wire_bits": 4},
    {"enable_adaptive_binarization": True},
])
def test_detector_refuses_unported_det_settings(update):
    """The detector runs only the served wire format and preprocessing;
    other values raise before any weights are built."""
    from ocr_system_tpu_torch.engine.detector import Detector
    from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS

    with pytest.raises(ValueError, match="port"):
        Detector(Settings(**{**SLICE_SETTINGS, **update}), device="cpu")


def test_engine_accepts_every_serving_default_but_script_routing():
    from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS, TorchOCREngine

    assert SLICE_SETTINGS == {"rec_charset": "latin", "det_split_column_gaps": False,
                              "rec_tighten_y": False}
    s = Settings(rec_charset="latin")
    assert (s.ocr_engine, s.enable_selection_marks, s.enable_handwriting_detection,
            s.det_glue_split) == ("hybrid", True, True, True)
    TorchOCREngine(s, device="cpu")
    for key in ("det_split_column_gaps", "rec_tighten_y"):
        with pytest.raises(ValueError, match="not ported yet"):
            TorchOCREngine(Settings(rec_charset="latin", **{key: True}), device="cpu")


def test_get_engine_builds_each_engine_once():
    """"jax", "classical" and "hybrid" get their detectors; concurrent first
    calls with one configuration build one engine; another configuration
    gets its own."""
    from concurrent.futures import ThreadPoolExecutor

    from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
    from ocr_system_tpu_torch.engine.detector import Detector
    from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector
    from ocr_system_tpu_torch.engine.pipeline import get_engine

    small = dict(rec_charset="latin", det_image_buckets=(64,), rec_width_buckets=(80,))
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
