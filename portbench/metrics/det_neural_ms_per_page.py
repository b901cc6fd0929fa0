"""Neural detection, host and device: the hybrid detector's
``stage_ms["det_neural"]``, or the neural engine's whole ``"det"``, after
each ``det_stage``, per page."""


def read(run):
    key = "det_neural" if any("det_neural" in c["ms"] for c in run.det_calls) else "det"
    return run.ms_per_page(run.det_calls, (key,))
