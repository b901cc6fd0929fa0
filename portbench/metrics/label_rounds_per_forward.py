"""Neural detection, label propagation: the rounds it ran over the calls
it served (the program's ``det.label_rounds`` over ``det.label_calls``);
each round reads one flag back to the host."""

from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    calls = S.total(spans, "det.label_calls") if spans else 0
    if not calls:
        return None
    return S.total(spans, "det.label_rounds") / calls
