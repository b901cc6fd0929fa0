"""Extraction, decode: the card's busy time inside the window's
``llm.decode`` spans (each document's decode steps: the absorbed attention
over the latent cache, the experts, the head; ``dsv2_yardstick.
decode_device``) over their ``tokens``, the steps."""

from portbench import dsv2_yardstick as Y
from portbench import spans as S


def read(run):
    decode = Y.decode_device(run)
    tokens = S.total([s for s, _ in decode or []], "tokens")
    if not tokens:
        return None
    return sum(took for _, took in decode) * 1e3 / tokens
