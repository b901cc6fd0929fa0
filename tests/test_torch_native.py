"""The port's native host ops (``ocr_system_tpu_torch/native``: g++-built
connected components and batch ink walk, bound through ctypes) against the
JAX package's native ops, bit for bit, and against the port's plain
versions (``native/plain.py``); the cv2 label order against OpenCV; the
build (concurrent builds, reuse, no fallback without a compiler); and
the served path calling them."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from ocr_system_tpu.native import cc_label as jax_cc
from ocr_system_tpu.native import ink_walk as jax_ink
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.native import build, cc_label, ink_walk, plain
from ocr_system_tpu_torch.utils import smoke

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the plain version's sums and moments accumulate in float64 by
# np.bincount, which adds in the same raster order as the native loop: they
# come out equal, and are held within this relative tolerance
SUM_RTOL = 1e-12


def _random(shape, density, seed):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.uint8)


def _checker(h, w):
    return ((np.arange(h)[:, None] + np.arange(w)[None, :]) % 2).astype(np.uint8)


def _diagonals(h, w):
    """Diagonal-only joins: down-right and down-left chains, a zigzag that
    merges two provisional labels late, and isolated pixels between."""
    m = np.zeros((h, w), np.uint8)
    for k in range(min(h, w)):
        m[k, k] = 1
        m[k, w - 1 - k] = 1
    m[h - 1, ::3] = 1
    for y in range(0, h, 2):
        m[y, w // 2] = 1  # a vertical dotted line: no joins
    return m


def _u_shapes(h, w):
    """Two arms that meet only at the bottom: labels merge in pass 1."""
    m = np.zeros((h, w), np.uint8)
    m[1:h - 1, 1] = m[1:h - 1, w - 2] = 1
    m[h - 2, 1:w - 1] = 1
    m[2:h - 3, w // 2] = 1  # a third arm, joined by nothing
    return m


MASKS = {
    **{f"random_{s[0]}x{s[1]}_{d}": _random(s, d, i)
       for i, (s, d) in enumerate([((301, 401), 0.05), ((301, 401), 0.3), ((301, 401), 0.45),
                                   ((240, 197), 0.6), ((97, 742), 0.7), ((960, 742), 0.45)])},
    "1x1_off": np.zeros((1, 1), np.uint8), "1x1_on": np.ones((1, 1), np.uint8),
    "1xW": _random((1, 57), 0.5, 7), "Hx1": _random((61, 1), 0.5, 8),
    "all_zero": np.zeros((33, 47), np.uint8), "all_one": np.ones((33, 47), np.uint8),
    "checker": _checker(40, 37), "checker_1xW": _checker(1, 9),
    "diagonals": _diagonals(45, 45), "u_shapes": _u_shapes(30, 41),
    "one_px_lines": np.kron(_random((20, 30), 0.4, 9), np.array([[1, 0]], np.uint8)),
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_matches_jax_native_and_plain(name):
    mask = MASKS[name]
    labels, n = cc_label.label(mask)
    want, want_n = jax_cc.label(mask)
    assert labels.dtype == np.int32 and n == want_n and np.array_equal(labels, want)
    plain_labels, plain_n = plain.label(mask)
    assert plain_n == n and np.array_equal(plain_labels, labels)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_stats_match_jax_native_and_plain(name):
    mask = MASKS[name]
    labels, n = cc_label.label(mask)
    prob = np.random.default_rng(len(name)).random(mask.shape).astype(np.float32)
    got = cc_label.stats(labels, prob, n)
    for g, w in zip(got, jax_cc.stats(labels, prob, n)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    counts, sums, bboxes = plain.stats(labels, prob, n)
    assert np.array_equal(counts, got[0]) and np.array_equal(bboxes, got[2])
    np.testing.assert_allclose(sums, got[1], rtol=SUM_RTOL, atol=0)


def test_stats_ignore_labels_above_n():
    """``n`` smaller than the labels' largest: the rest count nowhere."""
    labels, n = cc_label.label(MASKS["random_301x401_0.3"])
    prob = np.ones(labels.shape, np.float32)
    got = cc_label.stats(labels, prob, n // 2)
    for g, w, p in zip(got, jax_cc.stats(labels, prob, n // 2), plain.stats(labels, prob, n // 2)):
        assert np.array_equal(g, w) and np.array_equal(g, p)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("name", ["random_301x401_0.3", "random_960x742_0.45", "diagonals",
                                  "all_zero", "1x1_on", "checker"])
def test_analyze_matches_jax_native_and_plain(name, stride):
    mask = MASKS[name]
    h, w = mask.shape
    rng = np.random.default_rng(stride)
    prob = rng.random((-(-h // stride), -(-w // stride))).astype(np.float32)
    got = cc_label.analyze(mask, prob, stride=stride)
    want = jax_cc.analyze(mask, prob, stride=stride)
    assert got[1] == want[1]
    for g, w_ in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert g.dtype == w_.dtype and np.array_equal(g, w_)
    p = plain.analyze(mask, prob, stride=stride)
    assert p[1] == got[1] and np.array_equal(p[0], got[0])
    assert np.array_equal(p[2], got[2]) and np.array_equal(p[4], got[4])
    for k in (3, 5):
        np.testing.assert_allclose(p[k], got[k], rtol=SUM_RTOL, atol=0)


def test_analyze_grows_its_buffers():
    """A ``cap`` under the component count: the native op returns -2 and the
    binding retries with a larger buffer, as the JAX binding does."""
    mask = MASKS["random_301x401_0.3"]
    prob = np.random.default_rng(3).random(mask.shape).astype(np.float32)
    n = cc_label.label(mask)[1]
    assert n > 16
    cc_label.CALLS["cc_analyze_u8"].reset()
    got = cc_label.analyze(mask, prob, cap=4)
    assert cc_label.CALLS["cc_analyze_u8"].value >= 3  # 4 -> 16 -> 64 ...
    want = jax_cc.analyze(mask, prob, cap=4)
    assert got[1] == want[1] == n
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        assert np.array_equal(g, w)


CV_CASES = [((301, 401), 0.3), ((301, 401), 0.5), ((960, 742), 0.45), ((7, 5), 0.5),
            ((1, 9), 0.5), ((9, 1), 0.5), ((2, 2), 1.0)]


@pytest.mark.parametrize("shape,density", CV_CASES, ids=str)
def test_cv2_order_matches_cv2_and_plain(shape, density):
    mask = _random(shape, density, shape[1] + int(density * 10))
    labels, n = cc_label.label_cv2(mask)
    n_all, want, st, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    assert n == n_all - 1 and np.array_equal(labels, want)
    counts, _, bboxes = cc_label.stats(labels, mask.astype(np.float32), n)
    assert np.array_equal(counts[1:], st[1:, cv2.CC_STAT_AREA])
    x, y = st[1:, cv2.CC_STAT_LEFT], st[1:, cv2.CC_STAT_TOP]
    x1, y1 = x + st[1:, cv2.CC_STAT_WIDTH] - 1, y + st[1:, cv2.CC_STAT_HEIGHT] - 1
    assert np.array_equal(bboxes[1:], np.stack([x, y, x1, y1], 1))
    assert np.array_equal(plain.label_cv2(mask)[0], labels)


@pytest.fixture(scope="module")
def det_inputs():
    """What the served path hands the ink walk: the gray page and its
    axis-aligned DBNet quads before the walk, recorded from the port's
    detector (trained weights, float32) on committed Latin forms 1-2 and a
    Hindi form."""
    from ocr_system_tpu_torch.engine import detector as det_mod

    forms, _ = smoke.smoke_forms()
    pages = [forms[1], forms[2], smoke.hindi_forms()[0]]
    engine = smoke.build_engine("cpu", **smoke.NEURAL, compute_dtype="float32")
    seen = []
    real = det_mod.ink_expand_batch

    def record(gray, quads, *args):
        seen.append((gray.copy(), quads.copy()))
        return real(gray, quads, *args)

    det_mod.ink_expand_batch = record
    try:
        engine.detector.detect_batch(pages)
    finally:
        det_mod.ink_expand_batch = real
    assert len(seen) == len(pages) and all(len(q) > 10 for _, q in seen)
    return seen


def test_ink_walk_matches_jax_native_and_plain_on_det_boxes(det_inputs):
    for gray, quads in det_inputs:
        got = ink_walk.ink_expand_batch(gray, quads.copy())
        want = jax_ink.ink_expand_batch(gray, quads.copy())
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(plain.ink_expand_batch(gray, quads.copy()), got)
        assert not np.array_equal(got, quads)  # the walk moved some edges


def _edge_quads(rng, h, w, n):
    """Axis-aligned quads with fractional corners, many of them across
    the page edges or wholly off the page."""
    x0 = rng.uniform(-40, w + 10, n)
    y0 = rng.uniform(-30, h + 5, n)
    bw = rng.uniform(0.3, 120, n)
    bh = rng.uniform(0.3, 30, n)
    x1, y1 = x0 + bw, y0 + bh
    q = np.stack([np.stack([x0, y0], 1), np.stack([x1, y0], 1),
                  np.stack([x1, y1], 1), np.stack([x0, y1], 1)], 1)
    return q.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_ink_walk_matches_at_the_page_edges(seed):
    """Random quads on a committed form's corner, negative and
    out-of-page coordinates included: the native walk truncates before it
    clamps and keeps its threshold in float32, the plain one clamps first
    and works in float64; both give the same quads."""
    forms, _ = smoke.smoke_forms()
    gray = np.ascontiguousarray(rgb_to_gray(forms[seed])[:200, :300])
    quads = _edge_quads(np.random.default_rng(seed), *gray.shape, 300)
    got = ink_walk.ink_expand_batch(gray, quads.copy())
    assert np.array_equal(got, jax_ink.ink_expand_batch(gray, quads.copy()))
    assert np.array_equal(plain.ink_expand_batch(gray, quads.copy()), got)


def test_ink_walk_writes_in_place_and_takes_no_quads():
    gray = rgb_to_gray(smoke.smoke_forms()[0][1])
    empty = np.zeros((0, 4, 2), np.float32)
    assert ink_walk.ink_expand_batch(gray, empty) is empty
    quads = np.array([[[100, 100], [160, 100], [160, 112], [100, 112]]], np.float32)
    out = ink_walk.ink_expand_batch(gray, quads)
    assert out is quads


# ---------------- the build ----------------

def test_build_is_reused(tmp_path):
    so = build.build(tmp_path)
    stat = so.stat()
    assert build.build(tmp_path) == so
    again = so.stat()
    assert (again.st_ino, again.st_mtime_ns) == (stat.st_ino, stat.st_mtime_ns)
    assert so.parent.parent == tmp_path and so.name == "libocrnative.so"
    assert [p.name for p in so.parent.iterdir()] == ["libocrnative.so"]


def test_concurrent_builds_give_one_loadable_library(tmp_path):
    code = ("import sys; from pathlib import Path; from ocr_system_tpu_torch.native import build; "
            "print(build.build(Path(sys.argv[1])))")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    so = Path(paths.pop())
    assert sorted(p.name for p in so.parent.iterdir()) == ["libocrnative.so"]  # no temporaries
    lib = ctypes.CDLL(str(so))
    img = np.array([[1, 0, 1]], np.uint8)
    out = np.empty((1, 3), np.int32)
    lib.cc_label_u8.restype = ctypes.c_int32
    lib.cc_label_u8.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
    assert lib.cc_label_u8(img.ctypes.data, 1, 3, out.ctypes.data) == 2


def test_hash_covers_compiler_and_cpu(tmp_path, monkeypatch):
    first = build.library_path(tmp_path)
    monkeypatch.setattr(build, "cpu_model", lambda: "another CPU")
    assert build.library_path(tmp_path) != first
    monkeypatch.undo()
    monkeypatch.setattr(build, "compiler_version", lambda cxx: "g++ (other) 1.0")
    assert build.library_path(tmp_path) != first


def test_missing_compiler_raises_without_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build(tmp_path)
    assert not any(tmp_path.iterdir())
    monkeypatch.setattr(build, "_lib", None)
    for call in (lambda: cc_label.label(MASKS["checker"]),
                 lambda: ink_walk.ink_expand_batch(np.zeros((8, 8), np.uint8),
                                                   np.zeros((1, 4, 2), np.float32))):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()


def test_failed_compile_raises_and_leaves_nothing(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f( {\n")
    so = tmp_path / "out" / "lib.so"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.compile_once(so, [build.compiler(), *build.FLAGS, str(bad)])
    assert list(so.parent.iterdir()) == []


# ---------------- the served path ----------------

def test_served_path_calls_the_native_ops(monkeypatch):
    """The hybrid engine's wave (tiny buckets) and the probability-map box
    path call every native op, and no plain version."""
    from ocr_system_tpu_torch.engine.host_image import resize_linear
    from ocr_system_tpu_torch.engine.preprocess import PageImage

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was called on the served path")

    for name in ("label", "label_cv2", "stats", "analyze", "ink_expand_batch"):
        monkeypatch.setattr(plain, name, refuse)
    forms, expected = smoke.smoke_forms()
    page = resize_linear(forms[1], (320, 320))
    tiny = dict(det_image_buckets=(320,), rec_width_buckets=(80, 160), rec_batch_size=8)
    calls = {**cc_label.CALLS, **ink_walk.CALLS}
    for prob_bits, want in ((0, set(calls) - {"cc_analyze_u8"}), (4, {"cc_analyze_u8"})):
        engine = smoke.build_engine("cpu", **{**expected["settings"], **tiny},
                                    det_prob_wire_bits=prob_bits)
        for c in calls.values():
            c.reset()
        assert engine.process_pages([PageImage(page, 1)])[0].success
        assert all(calls[k].value > 0 for k in want), {k: c.value for k, c in calls.items()}


def test_concurrent_calls_agree_and_count():
    """The bindings release the GIL: 8 threads calling them at once get the
    single-threaded results, and the call counters lose no update."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    mask = MASKS["random_960x742_0.45"]
    prob = np.random.default_rng(5).random(mask.shape).astype(np.float32)
    want_labels, want_n = cc_label.label(mask)
    cc_label.CALLS["cc_analyze_u8"].reset()
    want = cc_label.analyze(mask, prob)
    per_analyze = cc_label.CALLS["cc_analyze_u8"].value  # with its buffer retries
    for c in cc_label.CALLS.values():
        c.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            futures = [ex.submit(cc_label.label, mask) for _ in range(16)]
            futures += [ex.submit(cc_label.analyze, mask, prob) for _ in range(16)]
            results = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    for labels, n in results[:16]:
        assert n == want_n and np.array_equal(labels, want_labels)
    for got in results[16:]:
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert cc_label.CALLS["cc_label_u8"].value == 16
    assert cc_label.CALLS["cc_analyze_u8"].value == 16 * per_analyze
