"""Neural detection, the det worker blocked on the card: the self time of
the program's ``device_sync`` spans under ``det_stage`` (each host read that
waits for the device: the label-propagation flag of each round, the
angles, the statistics, an overflow map), per page."""

from portbench import spans as S


def read(run):
    return S.ms_per_page(run, "device_sync", under="det_stage")
