"""Classical detection (the hybrid detector's CV pass): the engine's
``stage_ms["det_classical"]`` after each ``det_stage``, per page."""


def read(run):
    return run.ms_per_page(run.det_calls, ("det_classical",))
