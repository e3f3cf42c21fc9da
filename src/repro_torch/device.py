"""Device selection and numeric policy for the port.

The port runs on the GPU.  ``default_device`` never picks the CPU on its
own: a caller that wants the CPU (the tests do) passes ``device="cpu"``
explicitly, everything else gets ``cuda`` or an error.
"""
from __future__ import annotations

import torch

# float32 matrix products stay float32 on the card (no TF32 rounding), so
# the GPU logits are comparable with the CPU reference at 1e-4.  This is
# PyTorch's default; it is stated and set here so the policy is visible.
torch.backends.cuda.matmul.allow_tf32 = False


def default_device() -> torch.device:
    """``cuda`` — raises ``RuntimeError`` when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain versions")
    return torch.device("cuda")


def resolve(device: torch.device | str | None) -> torch.device:
    """The device a caller asked for, or the default one for ``None``."""
    return default_device() if device is None else torch.device(device)
