"""The share of pages the neural detector turned on the host (a skew
applied between its two passes: ``skew_angle`` non-zero on the detection
result) over the pages of every ``det_stage`` call of the window."""


def read(run):
    pages = sum(c["pages"] for c in run.det_calls if "turned" in c)
    if not pages:
        return None
    return 100.0 * sum(c["turned"] for c in run.det_calls if "turned" in c) / pages
