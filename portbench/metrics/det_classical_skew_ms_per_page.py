"""Classical detection, the skew search: the self time of the program's
``classical.skew`` spans (the page's 256 x 256 projection, its FFT and
the 31 angles' scores), per page of all pages. A log without the span, as
of a program that does not record it, reads None."""

from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    if spans is None or not any(s.name == "classical.skew" for s in spans):
        return None
    return S.ms_per_page(run, "classical.skew")
