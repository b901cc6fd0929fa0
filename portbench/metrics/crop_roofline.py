"""The crop kernel's share of its roofline: the least time the card needs
for each launch's bytes (``yardstick.crop_launch_bytes``: the crops
written once, the page pixels each box's taps can reach read once, at the
published HBM bandwidth) over the kernel's device time in the trace."""

from portbench import yardstick as Y

PROBE = "ocr_system_tpu_torch.engine.recognizer:crop_boxes"
KERNEL = "crop_kernel"


def LAUNCH(args, kwargs, out):
    """The page stack's shape, the boxes and widths (small device tensors,
    read after the window) and the output's shape, from the call
    ``crop_boxes(pages, aabbs, w_valid, out_shape, out_dtype)``."""
    pages, aabbs, w_valid = args[:3]
    return {"pages": (tuple(pages.shape), pages.element_size()),
            "aabbs": aabbs, "w_valid": w_valid,
            "out": (tuple(out.shape), out.element_size())}


def read(run):
    def least_bytes(launch):
        return Y.crop_launch_bytes({**launch, "aabbs": launch["aabbs"].cpu().numpy(),
                                    "w_valid": launch["w_valid"].cpu().numpy()})

    return run.roofline(PROBE, KERNEL, least_bytes)
