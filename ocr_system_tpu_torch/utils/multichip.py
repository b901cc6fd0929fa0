"""The multichip dry run (port of ``dryrun_multichip`` in the repository's
``__graft_entry__.py``): every path of the port that consults the mesh, on
an n-device mesh at tiny sizes.

    python -m ocr_system_tpu_torch.utils.multichip [N]

builds the meshes over the first N visible cards and raises without them;
``dryrun_multichip(n, devices=[d] * n)`` runs the same on a virtual mesh of
one repeated device (the CPU tests; the single H100). It runs a dp-sharded
recognizer step, a dp x tp layout step (its mlp and heads weights split
over tp), dp-sharded detection and recognition through the engine and the
page scheduler (the trained weights, 320-pixel pages), an sp ring-attention
forward against the dense one and a pp GPipe train step against the serial
stack, and prints what it ran and how many distinct devices each mesh had.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ocr_system_tpu_torch.core.mesh import Mesh, ShardedBatch, build_mesh, mesh_context


def _say(msg: str) -> None:
    print(f"[dryrun] {msg}", flush=True)


def _mesh(spec: str, devices) -> Mesh:
    mesh = build_mesh(spec, devices)
    _say(f"mesh {mesh.shape}: {len(mesh.distinct_devices())} distinct of {mesh.size} devices "
         f"({', '.join(map(str, mesh.distinct_devices()))})")
    return mesh


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run every mesh path on ``n_devices`` devices: ``devices`` (a device
    may repeat), else the first ``n_devices`` visible cards. Returns what
    each path measured."""
    from ocr_system_tpu_torch.core.dtypes import DTypePolicy
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
    from ocr_system_tpu_torch.parallel.sharding import ShardedDense
    from ocr_system_tpu_torch.training import train as T

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"{n_devices} cards asked for, "
                               f"{torch.cuda.device_count()} visible")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    f32 = DTypePolicy(compute_dtype=torch.float32)
    out: dict = {"n_devices": n_devices,
                 "distinct_devices": len(dict.fromkeys(map(str, devices)))}
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = _mesh(f"dp=-1,tp={tp}", devices)
    dp = mesh.shape["dp"]
    rng = np.random.default_rng(0)
    charset = get_charset("latin")

    # ---- dp-sharded recognizer CTC step ----
    b = dp * 2
    lengths = rng.integers(1, 9, b)
    batch = {"images": rng.integers(0, 256, (b, 48, 80)).astype(np.uint8),
             "widths": rng.integers(40, 81, b).astype(np.int32),
             "labels": np.where(np.arange(8) < lengths[:, None],
                                rng.integers(1, charset.size, (b, 8)), 0).astype(np.int32),
             "label_lengths": lengths.astype(np.int32)}
    rec = SVTRRecognizer(charset.size, dim=64, depth=2, heads=2, policy=f32)
    state = T.init_state(rec, 1e-3, mesh.lead, torch.Generator().manual_seed(0))
    state, m = T.make_rec_train_step(mesh)(state, T.to_device(batch, mesh.lead))
    out["rec_loss"] = m["loss"].item()
    _say(f"rec step ok over dp={dp}, loss={out['rec_loss']:.4f}")

    # ---- dp x tp layout step ----
    layout = LayoutExtractor(charset.size, dim=64, depth=2, heads=2, max_len=128)
    lstate = T.init_layout_state_sharded(layout, 1e-3, mesh, torch.Generator().manual_seed(1))
    if tp > 1 and not isinstance(layout.blocks[0].up, ShardedDense):
        raise AssertionError("expected the mlp kernel split over tp")
    lit = T.layout_batch_iterator(charset, b, max_len=64, seed=0)
    lstate, lm = T.make_layout_train_step(mesh=mesh)(lstate, T.to_device(next(lit), mesh.lead))
    out["layout_loss"] = lm["loss"].item()
    _say(f"layout step ok over dp={dp} x tp={tp}, loss={out['layout_loss']:.4f}")

    # ---- dp-sharded detection and recognition through the engine ----
    out.update(_engine(mesh, dp))

    # ---- sp ring attention against the dense forward ----
    sp_mesh = _mesh(f"dp=1,tp=1,sp={n_devices}", devices)
    seq = 64 * n_devices  # 64 tokens per device: every ring step is real
    kw = dict(vocab_size=charset.size, dim=64, depth=2, heads=2, max_len=seq)
    ring = LayoutExtractor(sequence_parallel=True, **kw).init_random_(
        torch.Generator().manual_seed(3)).to(sp_mesh.lead)
    dense = LayoutExtractor(**kw).to(sp_mesh.lead)
    dense.load_state_dict(ring.state_dict())
    ids = (torch.arange(2 * seq).reshape(2, seq) % 37).to(sp_mesh.lead)
    boxes = torch.full((2, seq, 4), 12, device=sp_mesh.lead)
    smask = (torch.arange(seq, device=sp_mesh.lead)[None] < seq - 5).expand(2, seq)
    with torch.no_grad(), mesh_context(sp_mesh):
        got = ring(ids, boxes, smask)["tag_logits"]
    with torch.no_grad():
        want = dense(ids, boxes, smask)["tag_logits"]
    out["sp_diff"] = (got - want)[smask].abs().max().item()
    if not out["sp_diff"] < 5e-2:
        raise AssertionError(f"ring vs dense tag_logits diff {out['sp_diff']}")
    _say(f"sp={n_devices} ring-attention forward ok (max |ring - dense| = "
         f"{out['sp_diff']:.2e})")

    # ---- pp GPipe train step ----
    out.update(_gpipe(devices, n_devices))
    _say("multichip OK")
    return out


def _engine(mesh: Mesh, dp: int) -> dict:
    """The served neural engine (trained weights, float32) on dp-sharded
    waves: det and rec stages, then two waves through the scheduler."""
    from ocr_system_tpu_torch.engine.host_image import resize_linear
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.engine.scheduler import PageScheduler
    from ocr_system_tpu_torch.utils import smoke

    forms, _ = smoke.smoke_forms()
    pages = [PageImage(resize_linear(f, (320, 320)), i + 1)
             for i, f in enumerate(forms[:dp * 2])]
    with mesh_context(mesh):
        eng = smoke.new_engine(mesh.lead, **smoke.NEURAL, det_image_buckets=(320,),
                               rec_width_buckets=(80, 160), rec_batch_size=8,
                               det_batch_size=dp, compute_dtype="float32")
        dets = eng.det_stage(pages)
        if dp > 1 and not isinstance(dets[0].canvas_stack, ShardedBatch):
            raise AssertionError("the det canvases are not split over dp")
        outs = eng.rec_stage(pages, dets)
        words = sum(len(o.layout_boxes) for o in outs)
        if not all(o.success for o in outs) or words == 0:
            raise AssertionError("dp-sharded det + rec failed")
        _say(f"dp-sharded det + rec ok ({len(outs)} pages, {words} boxes)")
        sched = PageScheduler(eng, eng.settings)
        outs2 = sched.process(pages)
        if not (all(o.success for o in outs2) and sched.stats.waves == 2
                and sched.stats.failed_pages == 0):
            raise AssertionError(f"scheduler: {sched.stats}")
        _say(f"dp-sharded PageScheduler ok ({sched.stats.waves} waves, {len(outs2)} pages)")
    return {"engine_pages": len(outs), "engine_boxes": words, "scheduler_waves": 2}


def _gpipe(devices, n_devices: int) -> dict:
    from ocr_system_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        serial_reference,
        stack_stage_params,
    )

    pp = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    pp_mesh = _mesh(f"dp=1,tp=1,pp={pp}", devices)
    dev = pp_mesh.lead
    g = torch.Generator().manual_seed(40)

    def stage_fn(p, x):
        return x + torch.tanh(x @ p["w1"]) @ p["w2"]

    d_model, hidden = 16, 32
    stages = [{"w1": torch.randn(d_model, hidden, generator=g) * 0.3,
               "w2": torch.randn(hidden, d_model, generator=g) * 0.3} for _ in range(pp)]
    stages = [{k: v.to(dev) for k, v in s.items()} for s in stages]
    xs = torch.randn(2 * pp, 2, d_model, generator=g).to(dev)
    tgt = torch.randn(2 * pp, 2, d_model, generator=g).to(dev)
    stacked = {k: v.requires_grad_() for k, v in stack_stage_params(stages).items()}
    loss = ((pipeline_apply(stage_fn, stacked, xs, pp_mesh) - tgt) ** 2).mean()
    loss.backward()
    with torch.no_grad():
        fwd_diff = (pipeline_apply(stage_fn, stacked, xs, pp_mesh)
                    - serial_reference(stage_fn, stages, xs)).abs().max().item()
    if not fwd_diff < 1e-4:
        raise AssertionError(f"pipeline vs serial forward diff {fwd_diff}")
    gnorm = sum(v.grad.square().sum() for v in stacked.values()).sqrt().item()
    if not gnorm > 0:
        raise AssertionError("pipeline grads are zero")
    _say(f"pp={pp} GPipe train step ok (loss={loss.item():.4f}, |grad|={gnorm:.3f}, "
         f"fwd vs serial {fwd_diff:.1e})")
    return {"pp": pp, "pp_loss": loss.item(), "pp_fwd_diff": fwd_diff}


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count())
