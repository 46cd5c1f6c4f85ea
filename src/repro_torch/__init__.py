"""PyTorch/CUDA port of the Neural Cache reproduction.

A second package beside the JAX reference ``repro``: the quantize -> pack ->
map -> plan -> execute -> simulate -> serve chain of quantized Inception v3
inference through the bit-serial emulation, on an NVIDIA GPU.  It imports
``torch`` and never ``jax`` or ``repro``.  Entry points take ``device=`` and
default to ``"cuda"``; without a GPU they raise unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
