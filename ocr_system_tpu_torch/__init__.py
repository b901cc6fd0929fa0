"""PyTorch/CUDA port of ocr_system_tpu for NVIDIA Hopper (H100).

The module layout mirrors ``ocr_system_tpu`` so each counterpart is easy to
find. The JAX package is the reference; this package imports nothing from it
(nor JAX, pydantic, cv2 or PIL at import time) and keeps its own copies of
the JAX-free helpers it needs.
"""
