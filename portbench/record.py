"""What the per-layer metric readers read: one run's spans, scheduler
counts, kernel launches and device trace, with the arithmetic several
readers share. A reader (``metrics/<name>.py``) defines ``read(run)``,
returning a number or None when the run holds nothing to read, and may
name a ``PROBE``: the ``module:attribute`` whose launches a traced run
records, each as ``LAUNCH(args, kwargs, out)`` returns it where the
reader defines one (small: shapes, and small tensors such as boxes).
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

from portbench import yardstick as Y
from portbench.reference import ops as R


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    window: object  # serve.Window
    det_calls: list
    rec_calls: list
    sched: list
    probes: dict
    trace: object  # trace.DeviceTrace or None
    peaks: dict | None
    settings: dict  # the configuration's settings
    weights: dict  # the configuration's weight paths, absolute
    window_s: float = 0.0

    def ms_per_page(self, calls: list, keys: tuple[str, ...]) -> float | None:
        """The summed stage ms of ``keys`` over the calls that report them,
        per page of those calls."""
        calls = [c for c in calls if all(k in c["ms"] for k in keys)]
        pages = sum(c["pages"] for c in calls)
        if not pages:
            return None
        return sum(c["ms"][k] for c in calls for k in keys) / pages

    def roofline(self, probe: str, kernel: str, least_bytes=Y.launch_bytes) -> float | None:
        """Bytes-bound time of the probed launches (``least_bytes`` of
        each) over the device time of the trace's ``kernel`` events, in
        percent; None where a launch could not be read."""
        launches = self.probes.get(probe)
        if (not launches or any(x is None for x in launches) or self.trace is None
                or self.peaks is None):
            return None
        dev_s = sum(t - s for name, s, t in self.trace.kernels if kernel in name)
        if dev_s <= 0:
            return None
        need_s = sum(least_bytes(x) for x in launches) / self.peaks["hbm_bytes_per_s"]
        return 100.0 * need_s / dev_s

    def model_flops(self) -> int:
        """Useful FLOPs of the pages served in the window: DBNet once per
        page at its canvas bucket, the recognizer once per served word at
        its width bucket."""
        det_buckets = sorted(self.settings["det_image_buckets"])
        rec_buckets = tuple(sorted(self.settings["rec_width_buckets"]))
        total = 0
        for served in self.window.served:
            for page in served.pages:
                if page is None:
                    continue
                quads, shape = page
                side = max(shape)
                bucket = next((b for b in det_buckets if side <= b), det_buckets[-1])
                total += Y.dbnet_flops(self.weights["det_checkpoint"], bucket)
                for q in quads:
                    total += Y.svtr_flops(self.weights["rec_checkpoint"],
                                          R.crop_plan(q, rec_buckets)[0])
        return total
