"""Recognition (crops, SVTR, CTC decode) with its rescue passes: the
engine's ``stage_ms`` ``rec`` + ``rescue`` after each ``rec_stage``, per
page."""


def read(run):
    return run.ms_per_page(run.rec_calls, ("rec", "rescue"))
