"""PyTorch/CUDA port of the DeepRecSys serving stack.

Mirrors the module layout of the JAX package (``kernels/``, ``layers/``,
``models/``, ``configs/``, ``data/``, ``serve/``, ``core/``) and shares no
code with it: this package imports ``torch`` and ``numpy`` only.  Its entry
points run on the GPU unless the caller passes ``device="cpu"``; nothing
here needs CUDA, ``nvcc`` or ``triton`` at import time — the hand-written
kernels under ``csrc/`` are compiled at their first launch.
"""
from repro_torch.device import default_device  # noqa: F401
