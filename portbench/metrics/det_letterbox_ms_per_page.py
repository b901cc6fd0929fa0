"""Neural detection, the host letterbox: the self time of the program's
``det.letterbox`` spans (the letterbox of each page, the canvas stack and
its wire pack, both passes), per page."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "det.letterbox")
