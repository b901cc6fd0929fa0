"""Extraction, prefill: the duration of the window's ``llm.prefill`` spans
(each document's prompt through every layer in the expanded form, into a
new latent cache), per page of the window's ``det_stage`` spans."""

from portbench import spans as S


def read(run):
    if not any(s.name == "llm.prefill" for s in S.in_window(run) or []):
        return None
    return S.ms_per_page(run, "llm.prefill", own=False)
