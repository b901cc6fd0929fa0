"""The enhance kernel's share of its roofline: the least time the card
needs for each launch's bytes (each input byte read once, each output byte
written once, at the published HBM bandwidth) over the kernel's device
time in the trace."""

PROBE = "ocr_system_tpu_torch.engine.detector:enhance_gray"
KERNEL = "enhance_kernel"


def read(run):
    return run.roofline(PROBE, KERNEL)
