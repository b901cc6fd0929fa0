"""Neural detection, the boxes: the self time of the program's ``det.emit``
spans (boxes from the statistics or the map, the ink walk, the quad pad,
the page components), per page."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "det.emit")
