"""Finishing (glue split, reading order, tables, marks, handwriting): the
engine's ``stage_ms`` ``glue`` + ``finish`` after each ``rec_stage``, per
page."""


def read(run):
    return run.ms_per_page(run.rec_calls, ("glue", "finish"))
