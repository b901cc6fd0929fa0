"""DBNet and SVTR, JAX vs port, under the float32 policy: random flax
parameters and the trained checkpoints, both converted by
ocr_system_tpu_torch/core/weights.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.dtypes import DTypePolicy as JaxPolicy
from ocr_system_tpu.engine.detector import Detector as JaxDetector
from ocr_system_tpu.engine.recognizer import Recognizer as JaxRecognizer
from ocr_system_tpu.models.dbnet import DBNet as JaxDBNet
from ocr_system_tpu.models.recognizer import SVTRRecognizer as JaxSVTR
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.dtypes import DTypePolicy
from ocr_system_tpu_torch.models.dbnet import DBNet
from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer

torch.set_num_threads(1)

ATOL = 1e-4
F32 = JaxPolicy(compute_dtype=jnp.float32)


def _perturbed(variables, seed):
    """Random parameters with non-trivial BatchNorm statistics (flax's init
    leaves them at identity, which would hide a stats mix-up)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if "var" in jax.tree_util.keystr(path):
            return np.abs(a) + 0.5 + np.abs(noise)
        return a + 0.1 * noise

    return jax.tree_util.tree_map_with_path(f, variables)


def _jax_prob(model, variables, x):
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False)["prob"])
    return fn(variables, jnp.asarray(x))


def _jax_logits(model, variables, x, widths):
    fn = jax.jit(lambda v, x, w: model.apply(v, x, w, train=False))
    return fn(variables, jnp.asarray(x), jnp.asarray(widths))


def _dbnet_prob(variables, x):
    model = DBNet(policy=DTypePolicy.from_names("float32"))
    model.load_state_dict(weights.dbnet_state_dict(variables))
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def _svtr_logits(variables, x, widths, vocab):
    model = SVTRRecognizer(vocab, policy=DTypePolicy.from_names("float32"))
    model.load_state_dict(weights.svtr_state_dict(variables))
    with torch.no_grad():
        logits, lengths = model.eval()(torch.from_numpy(x), torch.from_numpy(widths))
    return logits.numpy(), lengths.numpy()


@pytest.mark.parametrize("shape", [(2, 64, 96, 3), (1, 128, 64, 3)])
def test_dbnet_random_params(shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    model = JaxDBNet(policy=F32)
    init = jax.jit(lambda x: model.init(jax.random.PRNGKey(0), x, train=False))
    v = _perturbed(init(jnp.asarray(x)), 1)
    ref = np.asarray(_jax_prob(model, v, x))
    got = _dbnet_prob(v, x)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < ATOL


def test_svtr_random_params():
    rng = np.random.default_rng(2)
    x = rng.random((3, 48, 80, 3)).astype(np.float32)
    widths = np.array([80, 33, 17], np.int32)
    model = JaxSVTR(vocab_size=96, policy=F32)
    init = jax.jit(lambda x: model.init(jax.random.PRNGKey(1), x, None, train=False))
    v = _perturbed(init(jnp.asarray(x)), 3)
    ref, ref_len = _jax_logits(model, v, x, widths)
    got, got_len = _svtr_logits(v, x, widths, 96)
    assert np.array_equal(got_len, np.asarray(ref_len))
    assert np.abs(got - np.asarray(ref)).max() < ATOL


def test_dbnet_checkpoint():
    det = JaxDetector(JaxSettings(det_checkpoint="checkpoints/det",
                                  compute_dtype="float32"))
    x = np.random.default_rng(4).random((1, 128, 96, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, det.variables)
    ref = np.asarray(_jax_prob(det.model, v, x))
    assert np.abs(_dbnet_prob(v, x) - ref).max() < ATOL


def test_npz_copy_round_trips(tmp_path):
    """A converted state dict saved with save_npz is what the port's
    Recognizer loads from an .npz rec_checkpoint."""
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.recognizer import Recognizer

    model = JaxSVTR(vocab_size=96, policy=F32)
    x = np.zeros((1, 48, 80, 3), np.float32)
    v = jax.jit(lambda x: model.init(jax.random.PRNGKey(7), x, None, train=False))(x)
    state = weights.svtr_state_dict(jax.tree.map(np.asarray, v))
    path = weights.save_npz(tmp_path / "rec.npz", state)
    rec = Recognizer(Settings(rec_checkpoint=str(path), rec_charset="latin"), device="cpu")
    loaded = rec.model.state_dict()
    assert set(loaded) == set(state)
    assert all(torch.equal(loaded[k], state[k]) for k in state)


def test_svtr_checkpoint():
    rec = JaxRecognizer(JaxSettings(rec_checkpoint="checkpoints/rec_latin",
                                    compute_dtype="float32", rec_charset="latin"))
    x = np.random.default_rng(5).random((2, 48, 160, 3)).astype(np.float32)
    widths = np.array([160, 70], np.int32)
    v = jax.tree.map(np.asarray, rec.variables)
    ref, _ = _jax_logits(rec.model, v, x, widths)
    got, _ = _svtr_logits(v, x, widths, rec.charset.size)
    assert np.abs(got - np.asarray(ref)).max() < ATOL
