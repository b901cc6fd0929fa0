"""Script routing: the program's ``route`` spans (``_route_and_normalize``
in the det stage, its per-page pool timed whole), per page."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "route", own=False)
