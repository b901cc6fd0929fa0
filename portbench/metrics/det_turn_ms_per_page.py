"""Neural detection, the host deskew turn: the self time of the program's
``det.turn`` spans (the rotation of the pages found skewed; their
re-letterbox is ``det.letterbox``'s), per page of all pages."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "det.turn")
