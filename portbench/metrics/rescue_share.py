"""Recognition, rescues: the crops the rescues re-decoded (the program's
``rescue.redecoded``) over the crops recognized first (``rec.crops`` of the
``rec`` spans, outside their ``rescue``), in percent."""

from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    crops = S.total(spans, "rec.crops", "rec") if spans else 0
    if not crops:
        return None
    return 100.0 * S.total(spans, "rescue.redecoded") / crops
