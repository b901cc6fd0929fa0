"""Training in the port, its edges: checkpoints (``core/checkpoint.py``)
and trained files served by the engines, the ``train_models`` entry point
at a small size on the CPU, and the from-scratch init against flax's
initializers."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.dtypes import DTypePolicy as JaxPolicy
from ocr_system_tpu.models.dbnet import DBNet as JaxDBNet
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayout
from ocr_system_tpu.models.recognizer import SVTRRecognizer as JaxSVTR
from ocr_system_tpu_torch.core import checkpoint, weights
from ocr_system_tpu_torch.models.dbnet import DBNet
from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F32 = JaxPolicy(compute_dtype=jnp.float32)
VOCAB = 40


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _init(model, seed, *args, **kw):
    """flax's init, jitted, with the layout model's partitioning boxes
    unwrapped."""
    v = jax.jit(lambda *a: model.init(jax.random.PRNGKey(seed), *a, **kw))(*args)
    return jax.tree.map(lambda a: np.asarray(getattr(a, "value", a)), v,
                        is_leaf=lambda a: hasattr(a, "value"))


# ---------------- checkpoints ----------------


def test_checkpoint_round_trips(tmp_path):
    """save_checkpoint writes a float32 .npz that load_checkpoint and
    maybe_load read back exactly; a missing or empty path gives None; a
    trained DBNet (threshold head included) loads into the serving one."""
    model = DBNet(thresh_head=True).init_flax_(torch.Generator().manual_seed(0))
    path = checkpoint.save_checkpoint(tmp_path / "det.npz", model)
    state = checkpoint.load_checkpoint(path)
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert state[k].dtype == torch.float32 and torch.equal(state[k], v), k
    assert checkpoint.maybe_load(tmp_path / "missing.npz") is None
    assert checkpoint.maybe_load("") is None
    serving = DBNet()
    checkpoint.maybe_load(path, serving)
    assert torch.equal(serving.prob_head.up2.weight, model.prob_head.up2.weight)
    fresh = checkpoint.init_or_load(DBNet(), tmp_path / "missing.npz",
                                    torch.Generator().manual_seed(0))
    assert torch.equal(fresh.backbone.stem.conv.weight, model.backbone.stem.conv.weight)
    with pytest.raises(ValueError):
        checkpoint.save_checkpoint(tmp_path / "det", model)


def test_trained_checkpoints_serve(tmp_path):
    """Files the trainers write load into get_engine (det and rec, through
    det_checkpoint/rec_checkpoint) and get_extractor (extract_checkpoint):
    the engine's models hold the trained tensors."""
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.pipeline import get_engine
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor, get_extractor
    from ocr_system_tpu_torch.models.charsets import get_charset

    g = torch.Generator().manual_seed(1)
    det = DBNet(thresh_head=True).init_flax_(g)
    rec = SVTRRecognizer(get_charset("latin").size).init_flax_(g)
    lay = LayoutExtractor(get_charset("multilingual").size, dim=64, depth=2).init_flax_(g)
    paths = {n: checkpoint.save_checkpoint(tmp_path / f"{n}.npz", m)
             for n, m in (("det", det), ("rec", rec), ("extract", lay))}
    s = Settings(det_checkpoint=str(paths["det"]), rec_checkpoint=str(paths["rec"]),
                 extract_checkpoint=str(paths["extract"]), extract_dim=64, extract_depth=2,
                 rec_charset="latin", ocr_engine="jax", compute_dtype="float32")
    engine = get_engine(s, device="cpu")
    assert torch.equal(engine.detector.model.backbone.stem.conv.weight,
                       det.backbone.stem.conv.weight)
    assert engine.detector.model.thresh_head is None
    assert torch.equal(engine.recognizer.model.pos_embed, rec.pos_embed)
    ex = get_extractor(s, device="cpu")
    assert isinstance(ex, LayoutModelExtractor)
    assert torch.equal(ex.model.tok_embed.weight, lay.tok_embed.weight)


# ---------------- the entry point ----------------


def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "ocr_system_tpu_torch.training.train_models",
                           *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("target,args", [
    ("rec", ["--steps", "2", "--rec-width", "64"]),
    ("det", ["--steps", "2", "--det-size", "64"]),
    ("layout", ["--steps", "3", "--dim", "64", "--depth", "2", "--out", "lay.npz"]),
])
def test_train_models_quick_on_cpu(tmp_path, target, args):
    """``train_models <target> --quick --device cpu`` at a small size trains,
    writes its .npz under checkpoints/ (or --out), and the file loads into
    the model it trained; --resume continues from it."""
    proc = _cli(tmp_path, target, "--quick", "--device", "cpu", *args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {"rec": "checkpoints/rec_latin.npz", "det": "checkpoints/det.npz",
           "layout": "lay.npz"}[target]
    state = checkpoint.load_checkpoint(tmp_path / out)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in state.values())
    assert "metrics" in proc.stderr
    if target == "det":
        assert any(k.startswith("thresh_head.") for k in state)
    if target == "layout":
        proc = _cli(tmp_path, target, "--quick", "--device", "cpu", *args, "--resume", out,
                    "--steps", "1")
        assert proc.returncode == 0 and "resumed from" in proc.stderr, proc.stderr[-3000:]


def test_train_models_refuses_to_overwrite_the_serving_layout(tmp_path):
    """A layout run of another width than Settings.extract_dim/depth may not
    write checkpoints/extract.npz; nothing is trained or written. Without a
    card, the default device raises."""
    proc = _cli(tmp_path, "layout", "--quick", "--device", "cpu", "--dim", "64", "--depth", "2")
    assert proc.returncode != 0 and "refusing to overwrite" in proc.stderr
    assert not (tmp_path / "checkpoints").exists()
    proc = _cli(tmp_path, "layout", "--quick", "--steps", "1", "--dim", "64", "--depth", "2",
                "--out", "x.npz")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ---------------- from-scratch init ----------------


def _flax_leaves(variables):
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    return {jax.tree_util.keystr(p): np.asarray(getattr(a, "value", a)) for p, a in flat}


@pytest.mark.parametrize("name", ["rec", "det", "layout"])
def test_init_flax_statistics(name):
    """The port's from-scratch init against flax's initializers, parameter
    by parameter after conversion: the same shapes, constant tensors equal,
    and random ones (tensors of at least 2,000 values) with the same spread:
    mean within 0.1 std of 0, standard deviation within 10%, and where
    flax's draw is bounded (truncated normal, uniform: max |x| under 2.4
    std) the port's too. Same seed, same weights."""
    g = torch.Generator().manual_seed(0)
    if name == "rec":
        jm = JaxSVTR(vocab_size=VOCAB, dim=32, depth=1, heads=2, policy=F32)
        v = _init(jm, 0, jnp.zeros((1, 48, 64, 3)), jnp.array([64]))
        model = SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2)
        want = weights.svtr_state_dict(_np_tree(v))
    elif name == "det":
        jm = JaxDBNet(policy=F32)
        v = _init(jm, 0, jnp.zeros((1, 64, 64, 3)), train=True)
        model = DBNet(thresh_head=True)
        want = weights.dbnet_state_dict(_np_tree(v), thresh_head=True)
    else:
        jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=2, max_len=512, policy=F32)
        v = _init(jm, 0, jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, 4), jnp.int32),
                  jnp.ones((1, 8), jnp.int32))
        model = LayoutExtractor(VOCAB, dim=64, depth=2, heads=2, max_len=512)
        want = weights.layout_state_dict(v)
    model.init_flax_(g)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        p = got[k]
        assert p.shape == w.shape, k
        if w.std() == 0:
            assert torch.equal(p, w), k
        elif w.numel() >= 2000:
            assert abs(p.mean().item()) < 0.1 * w.std().item(), k
            assert abs(p.std().item() / w.std().item() - 1) < 0.1, (k, p.std(), w.std())
            if w.abs().max() < 2.4 * w.std():
                assert p.abs().max() < 2.4 * p.std(), k
    model2 = {"rec": lambda: SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2),
              "det": lambda: DBNet(thresh_head=True),
              "layout": lambda: LayoutExtractor(VOCAB, dim=64, depth=2, heads=2,
                                                max_len=512)}[name]()
    model2.init_flax_(torch.Generator().manual_seed(0))
    for k, v2 in model2.state_dict().items():
        assert torch.equal(v2, got[k]), k


def test_train_fixtures_are_current():
    """The training fixtures against what writes them
    (``export_torch_weights.py --only train``; rerun it when this fails):
    weights/det_thresh.npz is checkpoints/det's threshold head, converted;
    the committed rec and layout batches are the JAX iterators' at the
    record's seeds, byte for byte (the det batch comes from a pool that
    racing workers fill, so it is held by its digest only); and the JAX
    record was computed, with this JAX, from the committed batches and from
    the weights the port's trainers start from (digests)."""
    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.detector import Detector as JaxDetector
    from ocr_system_tpu.models.charsets import get_charset as jax_charset
    from ocr_system_tpu.training import train as JT
    from ocr_system_tpu_torch.utils import smoke

    det = _np_tree(JaxDetector(JaxSettings(det_checkpoint=str(REPO / "checkpoints/det"))).variables)
    want = {k: v for k, v in weights.dbnet_state_dict(det, thresh_head=True).items()
            if k.startswith("thresh_head.")}
    got = weights.load_npz(REPO / "ocr_system_tpu_torch/weights/det_thresh.npz")
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    record = smoke.train_expected()
    batches = smoke.train_batches()
    seeds = record["seeds"]
    fresh = {
        "rec": next(JT.rec_batch_iterator(jax_charset("latin"), 64, width=320,
                                          seed=seeds["rec"])),
        "layout": next(JT.layout_batch_iterator(jax_charset("multilingual"), 32, max_len=768,
                                                seed=seeds["layout"], pos_span=2048)),
    }
    for name, batch in fresh.items():
        assert batch.keys() == batches[name].keys()
        for k, v in batch.items():
            assert v.dtype == batches[name][k].dtype and np.array_equal(v, batches[name][k]), k
    assert record["jax"] == jax.__version__
    for name in smoke.TRAIN_NAMES:
        assert record["inputs"][name] == {"batch": smoke.digest(batches[name]),
                                          "start": smoke.digest(smoke.train_start(name))}, name
