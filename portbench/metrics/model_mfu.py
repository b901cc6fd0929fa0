"""The whole step: useful model FLOPs of the window (one DBNet forward per
page at its canvas, one recognizer forward per served word at its width
bucket, no padding crops) over the window's seconds, as a share of the
card's dense bf16 peak."""


def read(run):
    if run.peaks is None or not run.window_s:
        return None
    return 100.0 * run.model_flops() / run.window_s / run.peaks["bf16_flops"]
