"""Every function, class and method of the JAX package has a counterpart in
the port: read with ``ast`` from both packages, each top-level function and
class (public or private) and each method of a top-level class of
``ocr_system_tpu/<m>.py`` must be defined (or imported) under the same name
in ``ocr_system_tpu_torch/<m>.py`` (the kernels' modules under their port
names, ``MIRROR``). ``EXCEPTIONS`` maps each other name either to its port
name ("=name", or "=module.py::name" in another module; the test checks it
exists) or to the reason it has none. A new JAX name without a counterpart
or an entry fails the test."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "ocr_system_tpu"
PORT = REPO / "ocr_system_tpu_torch"

# JAX module -> its port, where the file name differs
MIRROR = {
    "kernels/preprocess_pallas.py": "kernels/enhance.py",
    "kernels/crop_pallas.py": "kernels/crop.py",
}

_KERNEL = "the Pallas kernel's body; the CUDA kernel is in csrc/kernels.cu"
_JIT = ("a jit lock, placement or compiled-function cache of XLA; the one-process mesh "
        "(core/mesh.py) runs eager PyTorch on each shard")
_SHARDING = "a jax.sharding spec; the one-process mesh (core/mesh.py) replaces it"

EXCEPTIONS = {
    # flax modules' __call__ is nn.Module.forward
    "models/backbone.py::ConvBNAct.__call__": "=ConvBNAct.forward",
    "models/backbone.py::SqueezeExcite.__call__": "=SqueezeExcite.forward",
    "models/backbone.py::InvertedResidual.__call__": "=InvertedResidual.forward",
    "models/backbone.py::Backbone.__call__": "=Backbone.forward",
    "models/backbone.py::FPNNeck.__call__": "=FPNNeck.forward",
    "models/dbnet.py::_Head.__call__": "=_Head.forward",
    "models/dbnet.py::DBNet.__call__": "=DBNet.forward",
    "models/recognizer.py::MixerBlock.__call__": "=MixerBlock.forward",
    "models/recognizer.py::SVTRRecognizer.__call__": "=SVTRRecognizer.forward",
    "models/layout_extractor.py::Block.__call__": "=Block.forward",
    "models/layout_extractor.py::LayoutExtractor.__call__": "=LayoutExtractor.forward",
    "models/layout_extractor.py::_dense": "=models/layers.py::Dense",
    "extract/layout_model.py::LayoutModelExtractor._forward": "=LayoutModelExtractor.forward",
    # the engine class is named for its framework; its methods keep their names
    "engine/pipeline.py::JaxOCREngine": "=TorchOCREngine",
    # the Pallas kernels and their helpers
    "kernels/crop_pallas.py::crop_boxes_matmul": "=crop_boxes",
    "kernels/crop_pallas.py::_kernel": _KERNEL,
    "kernels/preprocess_pallas.py::_kernel": _KERNEL,
    "kernels/preprocess_pallas.py::_blur5_rows": _KERNEL,
    "kernels/preprocess_pallas.py::_blur5_cols": _KERNEL,
    "kernels/preprocess_pallas.py::_g5": "=gauss5",
    "kernels/preprocess_pallas.py::_enhance_plane": "=_enhance_planes",
    "kernels/preprocess_pallas.py::fused_enhance_reference": "=fused_enhance_plain",
    # the native host ops' build and loading
    "native/build.py::build_library": "=build",
    "native/cc_label.py::_get_lib": "=native/build.py::library",
    "native/ink_walk.py::_get_lib": "=native/build.py::library",
    # renamed helpers
    "ops/device_boxes.py::_propagate_labels": "=propagate_labels",
    "ops/device_boxes.py::component_stats_single": "=component_stats",
    "training/train.py::_unpack_bits": "=unpack_bits",
    "engine/detector.py::_pad_quad": "=_pad_quads_batch",
    "engine/recognizer.py::_to_gray": "=engine/host_image.py::rgb_to_gray",
    "utils/profiler.py::_peak_flops": "=peak_flops",
    "engine/handwriting.py::_dilate": (
        "the JAX package's fallback where cv2 is missing; the port has no cv2 and "
        "always takes host_image.dilate (ROADMAP)"),
    # XLA's compile machinery, jit locks and sharding specs
    "engine/detector.py::Detector._forward_locked": _JIT,
    "engine/detector.py::Detector._place": _JIT,
    "engine/recognizer.py::Recognizer._multi_crop_rec_fn": _JIT,
    "engine/recognizer.py::Recognizer._multi_aabb_rec_fn": _JIT,
    "engine/recognizer.py::Recognizer._stack_placer": _JIT,
    "engine/recognizer.py::_pad_count": (
        "pads page and crop counts to keep XLA's compile keys few; eager PyTorch has "
        "no compile cache, so the port's batches are the ragged rectangle"),
    "core/mesh.py::data_sharding": _SHARDING,
    "parallel/sharding.py::batch_spec": _SHARDING,
    "parallel/sharding.py::batch_sharding": _SHARDING,
    "parallel/sharding.py::replicated_sharding": _SHARDING,
    "parallel/sharding.py::logical_to_mesh_sharding": _SHARDING,
    "parallel/sharding.py::unbox": "flax's boxed (partitioned) parameters; the port's are tensors",
    "training/train.py::TrainState.tree_flatten": "a JAX pytree registration",
    "core/compile_cache.py::enable_persistent_cache": (
        "XLA's persistent compile cache; eager PyTorch compiles nothing"),
}


def _names(path: Path, with_imports: bool = False) -> set[str]:
    """Top-level functions and classes, and the methods of top-level
    classes as "Class.method"; with_imports: also the names that the module
    imports at top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{sub.name}" for sub in node.body
                       if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif with_imports and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return out


def _jax_names() -> list[tuple[str, str]]:
    return [(str(path.relative_to(JAX)), name)
            for path in sorted(JAX.rglob("*.py")) for name in sorted(_names(path))]


def _port_module(rel: str) -> Path:
    return PORT / MIRROR.get(rel, rel)


def _exists(module: str, name: str) -> bool:
    path = PORT / module
    return path.is_file() and name in _names(path, with_imports=True)


def _counterpart(rel: str, name: str) -> str | None:
    """The port's module::name for a JAX name, or None where it has none."""
    module = str(_port_module(rel).relative_to(PORT))
    cls, _, method = name.partition(".")
    renamed = EXCEPTIONS.get(f"{rel}::{cls}", "") if method else ""
    if renamed.startswith("="):  # a renamed class: its methods keep their names
        name = f"{renamed[1:]}.{method}"
    if _exists(module, name):
        return f"{module}::{name}"
    return None


def test_every_jax_name_has_a_counterpart_or_an_exception():
    missing = []
    for rel, name in _jax_names():
        key = f"{rel}::{name}"
        if key in EXCEPTIONS:
            continue
        if _counterpart(rel, name) is None:
            missing.append(key)
    assert not missing, f"JAX names without a port counterpart or an EXCEPTIONS entry: {missing}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS))
def test_exception_is_needed_and_points_somewhere(key):
    """Each entry names a JAX name that exists and has no same-name
    counterpart; a port name it gives exists; a reason is a sentence."""
    rel, name = key.split("::")
    assert name in _names(JAX / rel), f"{key}: no such JAX name"
    assert _counterpart(rel, name) is None, f"{key} has a same-name counterpart: drop the entry"
    value = EXCEPTIONS[key]
    if value.startswith("="):
        target = value[1:]
        module, _, target_name = target.rpartition("::")
        module = module or str(_port_module(rel).relative_to(PORT))
        assert _exists(module, target_name), f"{key}: {module}::{target_name} not in the port"
    else:
        assert " " in value, f"{key}: give the reason in words"


def test_the_guard_sees_the_newly_ported_names():
    """The names this check was written for are found, by name, in the
    port's mirror module (each would fail the first test if removed)."""
    for rel, name in [("utils/profiler.py", "device_trace"),
                      ("utils/profiler.py", "det_rec_breakdown"),
                      ("ops/sampling.py", "in_bounds_mask"), ("ops/sampling.py", "affine_sample"),
                      ("ops/sampling.py", "rotation_matrix"), ("ops/sampling.py", "rotate"),
                      ("ops/image_ops.py", "resize_bilinear"), ("ops/image_ops.py", "letterbox"),
                      ("ops/image_ops.py", "median_denoise3"), ("ops/image_ops.py", "deskew"),
                      ("ops/image_ops.py", "preprocess_page"),
                      ("engine/preprocess.py", "compress_to_limit"),
                      ("extract/tables.py", "extract_table_fields")]:
        assert (rel, name) in _jax_names() and f"{rel}::{name}" not in EXCEPTIONS
        assert _counterpart(rel, name) == f"{rel}::{name}"
