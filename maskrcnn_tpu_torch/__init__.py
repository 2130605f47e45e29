"""maskrcnn_tpu_torch — the PyTorch/CUDA port of ``maskrcnn_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and numpy only, never JAX or the JAX package. Entry points run on the GPU
unless the caller passes ``device="cpu"``; the hand-written CUDA kernels
live in ``kernels/`` beside their plain-torch versions.
"""

__version__ = "0.1.0"
