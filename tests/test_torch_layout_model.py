"""The port's layout extractor against the JAX package's: the transformer
at a small random size (float32 and bf16), the bf16 ``.npz`` storage, the
committed weights against the orbax checkpoint they came from, the trained
512 x 8 model's fields on two committed pages, the decoding functions on
seeded tags, and the long-document path's chunks and tokens."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.dtypes import DTypePolicy as JaxPolicy
from ocr_system_tpu.extract import layout_model as jax_lm
from ocr_system_tpu.models import charsets as jax_charsets
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayoutExtractor
from ocr_system_tpu.parallel.sharding import unbox
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.extract import layout_model
from ocr_system_tpu_torch.extract.types import ExtractionResult
from ocr_system_tpu_torch.models import layout_extractor
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.utils import smoke

from export_torch_weights import rounded_bf16

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_, EXPECTED = smoke.smoke_forms()
DOCS = smoke.extract_documents(EXPECTED)
# bf16 compute of the small random model against JAX's bf16: the logits
# of two bf16 pipelines that round at different points (PyTorch's softmax
# and matmuls accumulate in float32 and round once; XLA's CPU backend
# rounds op by op) differ by up to ~3 bf16 ulps of their magnitude: at
# most 0.047 on logits up to 4.2 over four seeds; the bound is twice that
BF16_ATOL = 0.1


def _inputs(seed: int, b: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, n)).astype(np.int32)
    boxes = np.sort(rng.integers(0, layout_extractor.COORD_BUCKETS, (b, n, 4)), -1).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    mask[-1, n // 3:] = 0  # a padded sample
    return ids, boxes, mask


def _small_pair(seed: int, dim=64, depth=2, heads=4):
    vocab = get_charset("multilingual").size
    jm = JaxLayoutExtractor(vocab_size=vocab, dim=dim, depth=depth, heads=heads, max_len=128,
                            policy=JaxPolicy.from_names("float32"))
    ids, boxes, mask = _inputs(seed, 2, 8, vocab)
    variables = unbox(jax.jit(lambda r: jm.init(r, ids, boxes, mask))(jax.random.PRNGKey(seed)))
    variables = jax.tree.map(np.asarray, variables)
    pm = layout_extractor.LayoutExtractor(vocab, dim, depth, heads, max_len=128)
    pm.load_state_dict(weights.layout_state_dict(variables))
    return variables, pm, vocab


@pytest.mark.parametrize("seed,n", [(0, 16), (1, 48), (2, 128)])
def test_small_model_float32_matches_jax(seed, n):
    variables, pm, vocab = _small_pair(seed)
    jm = JaxLayoutExtractor(vocab_size=vocab, dim=64, depth=2, heads=4, max_len=128,
                            policy=JaxPolicy.from_names("float32"))
    ids, boxes, mask = _inputs(seed + 10, 2, n, vocab)
    want = jm.apply(variables, ids, boxes, mask)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a).long() for a in (ids, boxes, mask)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
        assert got[k].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_small_model_bf16_close_to_jax(seed):
    variables, pm, vocab = _small_pair(seed)
    jm = JaxLayoutExtractor(vocab_size=vocab, dim=64, depth=2, heads=4, max_len=128,
                            policy=JaxPolicy.from_names("bfloat16", "float32"))
    ids, boxes, mask = _inputs(seed + 20, 2, 64, vocab)
    want = jm.apply(variables, ids, boxes, mask)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a).long() for a in (ids, boxes, mask)), dtype=torch.bfloat16)
    for k in want:
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= BF16_ATOL, (k, err)


def test_sequence_parallel_is_refused():
    with pytest.raises(ValueError, match="not ported"):
        layout_extractor.LayoutExtractor(10, 16, 1, 2, sequence_parallel=True)


def test_layout_state_dict_covers_every_parameter():
    variables, pm, _ = _small_pair(3, depth=3)
    state = weights.layout_state_dict(variables)
    assert sorted(state) == sorted(pm.state_dict())
    n_jax = sum(a.size for a in jax.tree.leaves(variables))
    assert n_jax == sum(v.numel() for v in state.values())


def test_bf16_npz_round_trip_is_bit_for_bit(tmp_path):
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32) * 1e3)
    vals[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40])
    state = {"blocks.0.qkv.weight": vals.to(torch.bfloat16),
             "blocks.0.norm1.weight": vals[1].clone(),
             "tok_embed.weight": vals[2:5].to(torch.bfloat16), "counts": torch.arange(5)}
    rounded = weights.bf16_but_norms({k: v for k, v in state.items() if k != "counts"})
    assert rounded["blocks.0.norm1.weight"].dtype == torch.float32
    assert rounded["tok_embed.weight"].dtype == torch.bfloat16
    got = weights.load_npz(weights.save_npz(tmp_path / "w.npz", state))
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k].view(torch.int16) if v.dtype == torch.bfloat16 else got[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16 else v), k


# ---- the trained 512 x 8 model ----

@pytest.fixture(scope="module")
def jax_rounded():
    """The JAX package's extractor on checkpoints/extract, its parameters
    rounded to bf16 but LayerNorm (export_torch_weights.rounded_bf16)."""
    s = JaxSettings(extract_checkpoint=str(REPO / "checkpoints/extract"), compute_dtype="float32")
    ex = jax_lm.LayoutModelExtractor(s)
    ex.variables = rounded_bf16(ex.variables)
    return ex


@pytest.fixture(scope="module")
def port_f32():
    return layout_model.get_extractor(Settings(compute_dtype="float32"), device="cpu")


def test_committed_weights_equal_the_rounded_checkpoint(jax_rounded):
    """weights/extract.npz is checkpoints/extract converted, every tensor but
    LayerNorm's rounded to bf16 and stored as bf16, LayerNorm float32."""
    want = weights.layout_state_dict(jax.tree.map(np.asarray, jax_rounded.variables))
    got = weights.load_npz(layout_model.WEIGHTS)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if weights._is_norm(k) else torch.bfloat16), k
        assert torch.equal(got[k].float(), v), k


def test_get_extractor_serves_the_trained_model(port_f32):
    ex = port_f32
    assert isinstance(ex, layout_model.LayoutModelExtractor)
    assert len(ex.model.blocks) == 8 and ex.model.blocks[0].heads == 8
    assert ex.model.norm.weight.numel() == 512 and ex.model.max_len == 2048
    assert ex.model.tok_embed.weight.dtype == torch.float32
    assert ex.model.blocks[0].norm1.weight.dtype == torch.float32
    bf16 = layout_model.LayoutModelExtractor(Settings(), device="cpu")
    assert bf16.model.tok_embed.weight.dtype == torch.bfloat16
    assert bf16.model.blocks[0].norm1.weight.dtype == torch.float32


@pytest.mark.parametrize("name", ["pages/4", "pages/5"])
def test_trained_fields_match_jax_float32(name, jax_rounded, port_f32):
    """Forms 4 and 5 (~250 tokens each): the port's float32 fields equal the
    JAX package's on the rounded weights, run here and as committed."""
    words, wh, text = DOCS[name]
    want = smoke.result_record(jax_rounded.extract_from_layout(words, wh, ocr_text=text))
    got = smoke.result_record(port_f32.extract_from_layout(words, wh, ocr_text=text))
    assert got == want
    committed = smoke.extract_expected()["docs"]["float32"][name]
    assert {**got, "token_count": committed["token_count"]} == committed


# ---- decoding and the long-document path, no model ----

def _stub(module, cls):
    """An extractor with no model whose ``_extract_direct`` records the
    tokens of each window it is given."""
    ex = object.__new__(cls)
    ex.max_len = 2048
    ex.charset = module.get_charset("multilingual")
    seen = []

    def direct(word_boxes, page_wh, *args, **kwargs):
        seen.append(module.tokenize_layout(word_boxes, page_wh, ex.charset, ex.max_len))
        return (ExtractionResult if module is layout_model else jax_lm.ExtractionResult)()

    ex._extract_direct = direct
    return ex, seen


@pytest.mark.parametrize("name", ["pages/1", "pages", "mixed/3"])
def test_long_documents_chunk_and_tokenize_as_jax(name):
    """A page over 2048 tokens (form 1), the 8-page document and a short
    Hindi page through extract_from_layout's reading-order sort and chunk
    split, tokenized only: every window's ids, boxes, mask and word map
    equal the JAX package's."""
    words, wh, text = DOCS[name]
    port, got = _stub(layout_model, layout_model.LayoutModelExtractor)
    ref, want = _stub(jax_lm, jax_lm.LayoutModelExtractor)
    port.extract_from_layout(words, wh, ocr_text=text)
    ref.extract_from_layout(words, wh, ocr_text=text)
    assert len(got) == len(want) and len(got) >= (1 if name == "mixed/3" else 2)
    for a, b in zip(got, want):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


@pytest.mark.parametrize("name", ["mixed/1", "mixed/2", "pages/3"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoding_matches_jax_on_seeded_tags(name, seed):
    """element_vote, force_inline_split and decode_tags on seeded tag
    log-probs over a committed page's tokens (Hindi pages reach the
    Devanagari inline split)."""
    words, wh, _ = DOCS[name]
    charset = get_charset("multilingual")
    assert charset.chars == jax_charsets.get_charset("multilingual").chars
    ids, boxes, mask, word_of = layout_model.tokenize_layout(words, wh, charset, 2048)
    n = int(mask.sum())
    text = "".join(charset.id_to_char(int(i)) or " " for i in ids[:n])
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(len(ids), 5)).astype(np.float32) * 2
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    tags = np.argmax(logp, -1)
    types = rng.integers(0, len(layout_extractor.FIELD_TYPES), len(ids))
    conf = rng.random(len(ids)).astype(np.float32)
    a = layout_model.element_vote(logp, tags, word_of, n, text)
    b = jax_lm.element_vote(logp, tags, word_of, n, text)
    np.testing.assert_array_equal(a, b)
    a = layout_model.force_inline_split(a, word_of, text, n)
    b = jax_lm.force_inline_split(b, word_of, text, n)
    np.testing.assert_array_equal(a, b)
    got = layout_model.decode_tags(a, types, conf, text, boxes, n)
    want = jax_lm.decode_tags(b, types, conf, text, boxes, n)
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    for _ in range(50):
        kb, vb = (np.sort(rng.integers(0, 1024, 4)).astype(np.float32) for _ in range(2))
        assert layout_model._span_pair_cost(kb, vb) == jax_lm._span_pair_cost(kb, vb)
