"""The committed record of the JAX package's quality evaluation
(``assets/eval_expected.json``, ``assets/eval_renders.npz``, written by
export_torch_weights.py ``--only eval``) that chip_smoke.py holds the port
against on the card: every phase and dtype with its items and digests,
the detector settings; the recorded renders are the pixels the Recorders
digested, and the port draws them alike here; the port's evaluations on
the replayed renders give the record at float32; a replay out of order
raises."""

import numpy as np
import pytest
import torch

from ocr_system_tpu.training.devanagari_font import ensure_font
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.training import evaluate as E
from ocr_system_tpu_torch.training import synth as S
from ocr_system_tpu_torch.training import synth_forms as SF
from ocr_system_tpu_torch.utils import smoke
from ocr_system_tpu_torch.utils.smoke import Recorder

torch.set_num_threads(1)
ensure_font()  # the JAX renderer's font list, as the record was drawn


def test_the_committed_record_covers_every_phase():
    """assets/eval_expected.json: every eval phase at both dtypes with its
    items and digests, the seven detector settings on the committed forms,
    under 0.5 MB; and the port renders the recorded pixels here (the first
    lines of each rec run and the first page of each e2e row)."""
    assert smoke.EVAL_EXPECTED.stat().st_size < 0.5e6
    want = smoke.eval_expected()
    assert want["sizes"] == smoke.EVAL_SIZES
    for name in smoke.EVAL_PHASES:
        for dt in ("float32", "bfloat16"):
            runs = want["phases"][name][dt]
            assert runs and all(r["items"] for r in runs.values()), (name, dt)
    assert set(want["det_settings"]) == set(smoke.DET_SETTINGS)
    assert all(len(v) == smoke.DET_SETTINGS_FORMS for v in want["det_settings"].values())
    rec = want["phases"]["eval_rec"]["float32"]
    for cs in ("latin", "devanagari"):
        r = S.TextRenderer(get_charset(cs), seed=9999)
        for digest in rec[cs]["digests"][:3]:
            line = r.render_line(max_width=320, augment=False)
            assert smoke.pixels_digest((line.image * 255).astype(np.uint8)) == digest
    page = SF.render_spec(SF.FormGenerator(seed=5556).generate(800), augment=False)
    first = want["phases"]["eval_e2e_hybrid"]["float32"]["pages"]["digests"][0]
    assert smoke.pixels_digest((page.image * 255).astype(np.uint8)) == first


def test_the_committed_renders_are_the_recorded_pixels():
    """Every eval phase's render events (the JAX renderers' lines and pages)
    are, in order, the pixels its Recorder digested, and the port draws
    the first ones alike here (RenderLog of the port's renderers)."""
    want, arrays = smoke.eval_expected(), smoke.eval_renders()
    for name in smoke.EVAL_PHASES:
        events = want["renders"][name]
        digests = [d for run in want["phases"][name]["float32"].values()
                   for d in run["digests"]]
        assert [smoke.pixels_digest(arrays[ev["image"]]) for ev in events] == digests, name
    with smoke.RenderLog(S, SF) as log:
        r = S.TextRenderer(get_charset("devanagari"), seed=9999)
        for _ in range(3):
            r.render_line(max_width=320, augment=False)
        SF.render_spec(SF.FormGenerator(seed=4242).generate(960), augment=False)
    rec = want["renders"]["eval_rec"]
    for got, ev in zip(log.events[:3], rec[100:103], strict=True):  # after 100 Latin lines
        assert smoke.pixels_digest(got["image"]) == smoke.pixels_digest(arrays[ev["image"]])
        assert (got["text"], got["width"]) == (ev["text"], ev["width"])
    spec = want["renders"]["eval_forms_e2e"][0]
    assert smoke.pixels_digest(log.events[3]["image"]) == smoke.pixels_digest(
        arrays[spec["image"]])
    assert [list(e) for e in log.events[3]["elements"]] == spec["elements"]
    assert log.events[3]["dropped"] == spec["dropped"]
    assert np.array_equal(log.events[3]["quads"], arrays[spec["quads"]])


def test_replayed_renders_give_the_record():
    """The port's evaluations with the renderers replaying the JAX
    package's lines and pages: the record's items and scores at float32
    (the first 6 Devanagari lines; the first form through the hybrid
    engine and the trained extractor, its element boxes and dropped
    pairs restored from the record)."""
    want, arrays = smoke.eval_expected(), smoke.eval_renders()
    rec = want["renders"]["eval_rec"][100:]
    port = Recognizer(Settings(rec_checkpoint=str(smoke.PACKAGE / "weights" / "rec_devanagari.npz"),
                               compute_dtype="float32"), charset=get_charset("devanagari"),
                      device="cpu")
    got = Recorder(port)
    with smoke.ReplayedRenders(rec, arrays) as replay:
        E.evaluate_recognizer(got, get_charset("devanagari"), n_lines=6)
    assert replay.at == 6
    record = want["phases"]["eval_rec"]["float32"]["devanagari"]
    assert got.items == record["items"][:6] and got.digests == record["digests"][:6]
    kit = smoke.eval_kit("cpu", "float32")
    eng, ex = Recorder(kit["engines"]["hybrid"]), Recorder(kit["extractor"])
    with smoke.ReplayedRenders(want["renders"]["eval_forms_e2e"], arrays):
        E.evaluate_form_extraction_e2e(eng, ex, n_docs=1)
    record = want["phases"]["eval_forms_e2e"]["float32"]
    assert eng.digests == record["pages"]["digests"][:1]
    assert smoke.same_item(eng.items[0], record["pages"]["items"][0])
    assert ex.items == record["fields"]["items"][:1]


def test_a_replay_out_of_order_raises():
    want, arrays = smoke.eval_expected(), smoke.eval_renders()
    with smoke.ReplayedRenders(want["renders"]["eval_rec"], arrays):
        with pytest.raises(AssertionError, match="not in the record"):
            S.TextRenderer(get_charset("latin"), seed=1).render_page(size=256)
    with smoke.ReplayedRenders(want["renders"]["eval_signatures"], arrays):
        with pytest.raises(AssertionError, match="not the recorded one"):
            SF.render_spec(SF.FormGenerator(seed=1).generate(960))


def test_chip_smoke_phases_run_on_the_cpu():
    """chip_smoke.py's new phases at a tiny size on the CPU (the wrappers
    count no launches there): the fonts phase, an eval phase on the
    replayed renders against the record, and both trainers end to end on
    their own iterators."""
    import chip_smoke as cs

    want, arrays = smoke.eval_expected(), smoke.eval_renders()
    fonts = cs.phase_fonts(want)
    assert fonts["freetype2"] and len(fonts["fonts"]) == 6
    assert fonts["first_line_pixels_equal_record"] == {"latin": fonts["raqm"],
                                                       "devanagari": fonts["raqm"]}
    kits = {"float32": {"E": E, "charsets": {cs_: get_charset(cs_) for cs_ in
                                             ("latin", "devanagari")},
                        "rec": {cs_: Recognizer(Settings(
                            rec_checkpoint=str(smoke.PACKAGE / "weights" / f"rec_{cs_}.npz"),
                            compute_dtype="float32", storage_root="storage"),
                            charset=get_charset(cs_), device="cpu")
                            for cs_ in ("latin", "devanagari")}}}
    tiny = {**smoke.EVAL_SIZES, "lines": 3}
    events = want["renders"]["eval_rec"]
    renders = (events[:3] + events[100:103], arrays)
    with smoke.ReplayedRenders(*renders):
        own = {"float32": smoke.run_eval("eval_rec", kits["float32"], tiny)}
    for cs_ in ("latin", "devanagari"):
        record = want["phases"]["eval_rec"]["float32"][cs_]
        assert own["float32"][cs_]["items"] == record["items"][:3]
    row = cs.phase_eval("eval_rec", kits, own, renders=renders, sizes=tiny)
    assert row["renders"] == "replayed" and row["float32"]["misses"] == []
    assert all(r["items_alike"] == 1.0 for r in row["float32"]["runs"].values())
    for name in ("rec", "det"):
        row = cs.phase_train_cli(name, "cpu", steps=1, batch=2, size=64 if name == "det" else 160)
        assert row["host_steps_per_s"] > 0 and np.isfinite(row["loss_last"]), row
