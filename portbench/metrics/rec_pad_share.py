"""Recognition, padding: the share of the crop slots SVTR ran that held no
crop (the program's ``rec.crops`` over ``rec.slots`` in every dispatch,
rescues and glue split included), in percent."""

from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    slots = S.total(spans, "rec.slots") if spans else 0
    if not slots:
        return None
    return 100.0 * (1.0 - S.total(spans, "rec.crops") / slots)
