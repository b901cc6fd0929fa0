"""Classical detection, the ink mask: the self time of the program's
``classical.mask`` spans (the page's float64 luma and the adaptive
Gaussian threshold), per page of all pages. A log without the span, as of
a program that does not record it, reads None."""

from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    if spans is None or not any(s.name == "classical.mask" for s in spans):
        return None
    return S.ms_per_page(run, "classical.mask")
