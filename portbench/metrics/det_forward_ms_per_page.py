"""Neural detection, the forward's host side: the self time of the
program's ``det.forward`` spans (the device forward's dispatch and the host
work on its outputs, its ``device_sync`` waits left out), per page."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "det.forward")
