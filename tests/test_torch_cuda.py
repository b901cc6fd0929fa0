"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; elsewhere they skip. On the card
(whose Python has no jax, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from test_torch_ink_mask import tie_page

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import classical_detector
from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
from ocr_system_tpu_torch.engine.detector import turn_pages
from ocr_system_tpu_torch.engine.host_image import rotate_cubic
from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector
from ocr_system_tpu_torch.kernels import crop, enhance, ink_mask, rotate
from ocr_system_tpu_torch.utils import smoke
from ocr_system_tpu_torch.utils.profiler import SPANS
from ocr_system_tpu_torch.utils.smoke import bf16_agrees, bf16_disagreement

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU runs the plain versions only")
    return torch.device("cuda")


def _assert_close(got, ref):
    """float32 within 1e-5; bf16 under the shared bf16 rule."""
    if got.dtype == torch.bfloat16:
        assert bf16_agrees(got, ref), bf16_disagreement(got, ref)
    else:
        assert (got - ref).abs().max() < 1e-5


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 480, 100), (3, 37, 45)])
def test_enhance_kernel_matches_plain(cuda, shape, out_dtype):
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda)
    means = enhance.gray_means(gray)
    rgb = torch.from_numpy(rng.random((*shape, 3), np.float32)).to(cuda)
    before = enhance.LAUNCHES.value
    got = enhance.enhance_gray(gray, means, out_dtype)
    assert got.dtype == out_dtype and got.shape == (shape[0], 3, *shape[1:])
    _assert_close(got, enhance.enhance_gray_plain(gray, means))
    got = enhance.fused_enhance(rgb, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == rgb.shape
    _assert_close(got, enhance.fused_enhance_plain(rgb))
    torch.cuda.synchronize()
    assert enhance.LAUNCHES.value == before + 2


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "rows,cols,n,width",
    [(256, 256, 7, 320), (48, 320, 3, 160), (960, 960, 40, 640), (960, 960, 40, 1280),
     (256, 256, 7, 100), (37, 45, 5, 45)],
)
def test_crop_kernel_matches_plain(cuda, rows, cols, n, width, out_dtype):
    rng = np.random.default_rng(1)
    pages = torch.from_numpy(rng.integers(0, 256, (2, rows, cols), np.uint8)).to(cuda)
    x0 = rng.uniform(-20, cols, (2, n))
    y0 = rng.uniform(-10, rows, (2, n))
    h = rng.uniform(8, 300, (2, n))
    aabbs = np.stack([x0, y0, x0 + h * width / 48, y0 + h], -1).astype(np.float32)
    wv = rng.integers(16, width + 1, (2, n)).astype(np.int32)
    args = (pages, torch.from_numpy(aabbs).to(cuda), torch.from_numpy(wv).to(cuda), (48, width))
    before = crop.LAUNCHES.value
    got = crop.crop_boxes(*args, out_dtype)
    assert got.dtype == out_dtype
    _assert_close(got, crop.crop_boxes_plain(*args))
    torch.cuda.synchronize()
    assert crop.LAUNCHES.value == before + 1


ROTATE_ANGLES = [0.5, -0.5, 1.999999, -1.999999, 4.0, -4.0, 45.0, -45.0]


@pytest.mark.parametrize("fill", [255, 0])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", [(960, 960), (961, 1283)])
def test_rotate_kernel_is_rotate_cubic_bit_for_bit(cuda, shape, channels, fill):
    """One batch of the eight angles, one launch, each page equal to the
    host version's turn of it."""
    rng = np.random.default_rng(7)
    pages = rng.integers(0, 256, (len(ROTATE_ANGLES), *shape, channels), np.uint8)
    # a white margin and dark strokes, as a scanned page has, beside noise
    pages[:, :40] = 255
    pages[:, 200:204] = 0
    before = rotate.LAUNCHES.value
    got = rotate.rotate_pages(torch.from_numpy(pages).to(cuda), ROTATE_ANGLES, fill).cpu()
    torch.cuda.synchronize()
    assert rotate.LAUNCHES.value == before + 1
    for page, angle, out in zip(pages, ROTATE_ANGLES, got):
        want = rotate_cubic(page, angle, fill)
        assert np.array_equal(out.numpy(), want), (
            angle, int((out.numpy() != want).sum()))


def test_turn_pages_launches_once_per_shape(cuda):
    """The detector's turn on a card: pages grouped by shape, one launch a
    group, each page back as its own (H, W[, C]) u8 array equal to
    rotate_cubic's."""
    rng = np.random.default_rng(8)
    pages = [rng.integers(0, 256, shape, np.uint8)
             for shape in ((200, 300, 3), (120, 90, 3), (200, 300, 3), (64, 80))]
    # a channel-last view of planar storage, as the benchmark's pages are
    pages.append(rng.integers(0, 256, (3, 200, 300), np.uint8).transpose(1, 2, 0))
    angles = [3.0, -2.0, 0.7, 10.0, -4.0]
    before = rotate.LAUNCHES.value
    got = turn_pages(pages, angles, cuda)
    assert rotate.LAUNCHES.value == before + 3
    for page, angle, out in zip(pages, angles, got):
        assert isinstance(out, np.ndarray) and out.shape == page.shape
        assert np.array_equal(out, rotate_cubic(page, angle, fill=255))


# the ink mask's pages: the 8 committed forms upright and turned, a page
# of rounding ties, OpenCV's tail widths (0, 3, 4, 5, 7 mod 8) and pages
# under the 31-pixel block
INK_PAGES = ([f"form{k}" for k in range(8)] + [f"turned{k}" for k in range(8)]
             + ["ties", "w64", "w67", "w68", "w69", "w71", "20x27", "5x3"])


@pytest.fixture(scope="module")
def ink_pages():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU runs the plain versions only")
    forms = smoke.smoke_forms()[0]
    angles = [float(a) for a in np.linspace(-3.5, 3.5, 8)]
    # the rotate kernel is rotate_cubic bit for bit (above)
    turned = rotate.rotate_pages(torch.from_numpy(forms).cuda(), angles).cpu().numpy()
    pages = {f"form{k}": f for k, f in enumerate(forms)}
    pages.update({f"turned{k}": t for k, t in enumerate(turned)})
    pages["ties"] = tie_page(240, 328, seed=11)
    pages.update({f"w{w}": tie_page(45, w, seed=w) for w in (64, 67, 68, 69, 71)})
    pages["20x27"], pages["5x3"] = tie_page(20, 27, seed=47), tie_page(5, 3, seed=8)
    return pages


@pytest.mark.parametrize("name", INK_PAGES)
def test_ink_mask_kernel_is_the_host_mask_bit_for_bit(cuda, ink_pages, name):
    """One launch a page, its mask equal to the plain version's and to the
    host ``_ink_mask``'s."""
    page = ink_pages[name]
    before = ink_mask.LAUNCHES.value
    got = ink_mask.ink_mask_pages(torch.from_numpy(page).to(cuda)).cpu()
    torch.cuda.synchronize()
    assert ink_mask.LAUNCHES.value == before + 1
    plain = ink_mask.ink_mask_pages_plain(torch.from_numpy(page))
    assert torch.equal(got, plain), int((got != plain).sum())
    assert np.array_equal(got.numpy(), classical_detector._ink_mask(page))


def test_hybrid_classical_pass_on_the_card_is_the_hosts(cuda):
    """The hybrid detector's classical pass on the card (the mask kernel,
    the rotate kernel for its re-turns) finds the boxes, angles and pages
    of a classical pass on the host, on the neural pass's pages of the 8
    committed forms (one as a channel-last view of planar storage); every
    page goes through the kernel once, and each ``classical.mask`` span
    counts its card page beside its ``classical.skew`` span's page."""
    s = Settings(**smoke.TRAINED, ocr_engine="hybrid")
    hybrid = HybridDetector(s, device=cuda)
    pages = [d.page for d in hybrid.neural.detect_batch(list(smoke.smoke_forms()[0]))]
    pages[3] = np.ascontiguousarray(pages[3].transpose(2, 0, 1)).transpose(1, 2, 0)
    before = ink_mask.LAUNCHES.value
    SPANS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = hybrid.classical.detect_batch(pages)
    assert ink_mask.LAUNCHES.value == before + len(pages)
    spans = list(SPANS.spans)
    masks = [s.counts for s in spans if s.name == "classical.mask"]
    skews = [s.counts["skew.pages"] for s in spans if s.name == "classical.skew"]
    assert masks == [{"mask.card_pages": 1}] * len(pages)
    assert skews == [1] * len(pages)
    want = ClassicalDetector(s).detect_batch(pages)
    for g, w in zip(got, want, strict=True):
        assert g.skew_angle == w.skew_angle and np.array_equal(g.page, w.page)
        assert len(g.boxes) == len(w.boxes) > 0
        for a, b in zip(g.boxes, w.boxes):
            assert np.array_equal(a.quad, b.quad) and a.score == b.score


def test_wrappers_reject_bad_inputs(cuda):
    means = torch.zeros(1, device=cuda)
    with pytest.raises(ValueError):
        enhance.enhance_gray(torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda), means)
    with pytest.raises(ValueError):  # the detector's entry takes the u8 canvas
        enhance.enhance_gray(torch.zeros((1, 8, 8), device=cuda), means)
    gray = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        enhance.enhance_gray(gray, means, torch.float16)
    with pytest.raises(ValueError):
        enhance.fused_enhance(torch.zeros((1, 8, 8, 3), device=cuda), out_dtype=torch.float16)
    pages = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        crop.crop_boxes(pages, torch.zeros((1, 2, 4), device=cuda),
                        torch.ones((1, 2), dtype=torch.int64, device=cuda), (48, 80))
    with pytest.raises(ValueError):
        crop.crop_boxes(pages, torch.zeros((1, 2, 4), device=cuda),
                        torch.ones((1, 2), dtype=torch.int32, device=cuda), (48, 80),
                        torch.float16)
    page = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):  # dtype
        rotate.rotate_pages(page.float(), [1.0])
    with pytest.raises(ValueError):  # rank
        rotate.rotate_pages(page[0], [1.0])
    with pytest.raises(ValueError):  # not contiguous
        rotate.rotate_pages(page.transpose(1, 2), [1.0])
    with pytest.raises(ValueError):  # channels
        rotate.rotate_pages(page[..., :2].contiguous(), [1.0])
    with pytest.raises(ValueError):  # one angle per page
        rotate.rotate_pages(page, [1.0, 2.0])
    with pytest.raises(ValueError):  # fill is a u8 value
        rotate.rotate_pages(page, [1.0], fill=256)
    with pytest.raises(ValueError):  # the ink mask takes one (H, W, 3) u8 page
        ink_mask.ink_mask_pages(page)
    with pytest.raises(ValueError):
        ink_mask.ink_mask_pages(page[0].float())
    with pytest.raises(ValueError):
        ink_mask.ink_mask_pages(page[0, ..., :2].contiguous())
    with pytest.raises(ValueError):  # not contiguous
        ink_mask.ink_mask_pages(page[0].transpose(0, 1))


def test_the_decode_graph_steps_like_eager_decode(cuda):
    """The generative extractor's decode step as one CUDA graph
    (``GreedyDecoder``) gives the ids and logits of the same step run
    eagerly."""
    from ocr_system_tpu_torch.models import deepseek_v2 as D

    model = D.DeepSeekV2(D.PRESETS["deepseek_v2_tiny"], 3, cuda, torch.bfloat16)
    ids = torch.arange(3, 40, device=cuda)
    logits, cache = model.prefill(ids, 60)
    decoder = D.GreedyDecoder(model, cache, logits.argmax())
    assert decoder.graph is not None
    got = []
    for _ in range(16):
        got.append((int(decoder.step()), decoder.logits.clone()))
    logits, cache = model.prefill(ids, 60)
    eager = D.GreedyDecoder(model, cache, logits.argmax())
    for i, logits in got:
        eager._step()  # the captured step, run eagerly
        eager.cache.length += 1
        assert int(eager.ids) == i
        torch.testing.assert_close(eager.logits, logits, rtol=0, atol=0)


def test_documents_extract_at_once_beside_other_device_work(cuda):
    """The server extracts each upload in a thread of its own while other
    uploads run their OCR: ``generate`` in two threads at once, beside a
    thread that all the while does what the OCR path does on the card
    (allocates, launches, copies both ways, reads results back, waits for
    its stream and for an event), gives each prompt the ids it gives alone,
    and nothing raises: a decode graph's capture forbids unsafe calls in
    its own thread only. (A device-wide ``torch.cuda.synchronize``, a new
    pool stream that wraps round to the capture's, or a draw from the
    default CUDA generator would still be refused during a capture; the
    served path makes none.)"""
    import threading

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.extract.llm import DeepSeekV2Extractor

    ext = DeepSeekV2Extractor(Settings(llm_model="deepseek_v2_tiny", llm_max_new_tokens=24),
                              device=cuda)
    prompts = [list(range(3, 40)), list(range(50, 71))]
    want = [ext.generate(p) for p in prompts]
    stop, errors, got = threading.Event(), [], [[], []]

    def other_work():
        k = 0
        try:
            while not stop.is_set():
                k += 1
                torch.empty((k % 97 + 1) << 20, dtype=torch.uint8, device=cuda).fill_(1)
                x = torch.zeros(256 * (64 + k % 97)).to(cuda).view(-1, 256) + k
                y = x @ x.T
                y.sum().item()
                y[0, :4].tolist()
                torch.cuda.current_stream().synchronize()
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    def extract(i):
        try:
            for _ in range(6):
                got[i].append(ext.generate(prompts[i]))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    other = threading.Thread(target=other_work)
    other.start()
    workers = [threading.Thread(target=extract, args=(i,)) for i in range(2)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    stop.set()
    other.join()
    assert not errors, errors
    assert got == [[want[0]] * 6, [want[1]] * 6]
