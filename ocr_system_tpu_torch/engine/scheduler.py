"""Page batch scheduler: waves with page-level retry (port of
ocr_system_tpu/engine/scheduler.py). Under a dp mesh the detector pads
each wave to the dp size and splits it over the mesh; the det worker
serves under the caller's mesh (a mesh is set per thread).

Retry at the batch-scheduler level with page-level idempotent
re-dispatch on a failed wave. Pages are embarrassingly parallel, so the
scheduler:

  1. groups pages into det-batch-sized waves,
  2. dispatches each wave through the engine,
  3. on a wave failure, re-dispatches its pages INDIVIDUALLY (isolating a
     poison page), and marks pages that fail twice as failed OCROutputs
     instead of sinking the document.

The reference's analog is the Semaphore(1) serial loop + LangGraph retry
(ocr_service.py:620-627, extraction_service.py:169-183).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.mesh import current_mesh, mesh_context
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.utils.profiler import SPANS, StageTimer, span, span_ids

logger = logging.getLogger(__name__)


@dataclass
class ScheduleStats:
    waves: int = 0
    retried_pages: int = 0
    failed_pages: int = 0


class PageScheduler:
    def __init__(self, engine, settings: Settings | None = None):
        self.engine = engine
        self.settings = settings or get_settings()
        self.stats = ScheduleStats()
        # per-stage serving timings (SURVEY §5.1 device-side observability):
        # det_wait = det time NOT hidden by the rec overlap (pipelined path),
        # rec = recognition incl. decode. Surfaced on DocumentOCRResult and
        # logged per document by the orchestrator's ProcessingLog.
        self.timer = StageTimer()

    def process(self, pages: list[PageImage]) -> list:
        """Returns one OCROutput per page, never raises on per-page failures.

        Waves are PIPELINED when the engine exposes det/rec stages: a det
        worker thread runs detection (device dispatch + host box extraction)
        for wave N+1 while the main thread runs recognition for wave N — the
        two stages share one device queue, so transfers and host postprocess
        overlap device compute instead of serializing with it.

        Every span of the call carries its call id and its wave's index,
        in the det worker too (``utils/profiler.span_ids``).
        """
        call = SPANS.new_call()
        with span_ids(call, -1), span("process"):
            return self._process(pages, call)

    def _process(self, pages: list[PageImage], call: int) -> list:
        from ocr_system_tpu_torch.engine.pipeline import OCROutput

        wave_size = max(self.settings.det_batch_size, 1)
        waves = [
            list(enumerate(pages))[start : start + wave_size]
            for start in range(0, len(pages), wave_size)
        ]
        outputs: dict[int, object] = {}
        pipelined = hasattr(self.engine, "det_stage") and hasattr(
            self.engine, "rec_stage"
        )

        def handle_wave_failure(wave, err):
            logger.warning("wave failed (%s); page-level re-dispatch", err)
            for i, page in wave:
                self.stats.retried_pages += 1
                try:
                    outputs[i] = self.engine.process_pages([page])[0]
                except Exception as e2:
                    logger.error(
                        "page %d failed twice: %s", page.page_number, e2
                    )
                    self.stats.failed_pages += 1
                    outputs[i] = OCROutput(
                        success=False,
                        page_number=page.page_number,
                        page_width=float(page.width),
                        page_height=float(page.height),
                        error=f"page processing failed: {e2}",
                    )

        if pipelined and len(waves) > 1:
            from concurrent.futures import ThreadPoolExecutor

            # det runs at most PREFETCH waves ahead of rec: each in-flight
            # DetResult pins its device canvas stack (+ prob maps) in HBM
            # (~1.6 MB/page at the 1280 bucket), so unbounded prefetch would
            # grow device memory with document length. Futures are dropped
            # as soon as rec consumes them so the canvases free promptly.
            PREFETCH = 2
            # det workers: a det wave is ~half wire/device (GIL-free —
            # upload, forward, prob fetch) and ~half host numpy; with two
            # waves in flight the wire/device half of wave N+2 overlaps the
            # host half of wave N+1 while rec runs wave N on the main
            # thread. Configurable for A/B (VERDICT r4 #7) — see README
            # perf notes for the measured setting.
            workers = max(self.settings.det_workers, 1)
            mesh = current_mesh()

            def det_stage(wave_i):
                wave_pages = [p for _, p in waves[wave_i]]
                with span_ids(call, wave_i):
                    if mesh is None:
                        return self.engine.det_stage(wave_pages)
                    with mesh_context(mesh):
                        return self.engine.det_stage(wave_pages)

            with ThreadPoolExecutor(
                workers, thread_name_prefix="det"
            ) as det_pool:
                det_futs: list = [None] * len(waves)
                for k in range(min(PREFETCH, len(waves))):
                    det_futs[k] = det_pool.submit(det_stage, k)
                for w_i, wave in enumerate(waves):
                    self.stats.waves += 1
                    with span_ids(call, w_i):
                        try:
                            fut, det_futs[w_i] = det_futs[w_i], None
                            with self.timer.stage("det_wait"):
                                dets = fut.result()
                            nxt = w_i + PREFETCH
                            if nxt < len(waves):
                                det_futs[nxt] = det_pool.submit(det_stage, nxt)
                            with self.timer.stage("rec"):
                                results = self.engine.rec_stage(
                                    [p for _, p in wave], dets
                                )
                            dets = None
                            for (i, _), r in zip(wave, results):
                                outputs[i] = r
                        except Exception as e:
                            nxt = w_i + PREFETCH
                            if nxt < len(waves) and det_futs[nxt] is None:
                                det_futs[nxt] = det_pool.submit(det_stage, nxt)
                            handle_wave_failure(wave, e)
        else:
            for w_i, wave in enumerate(waves):
                self.stats.waves += 1
                with span_ids(call, w_i):
                    try:
                        if pipelined:
                            with self.timer.stage("det_wait"):
                                dets = self.engine.det_stage(
                                    [p for _, p in wave]
                                )
                            with self.timer.stage("rec"):
                                results = self.engine.rec_stage(
                                    [p for _, p in wave], dets
                                )
                        else:
                            with self.timer.stage("det_rec"):
                                results = self.engine.process_pages(
                                    [p for _, p in wave]
                                )
                        for (i, _), r in zip(wave, results):
                            outputs[i] = r
                    except Exception as e:
                        handle_wave_failure(wave, e)
        return [outputs[i] for i in range(len(pages))]
