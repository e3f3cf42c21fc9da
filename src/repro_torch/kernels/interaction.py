"""ctypes binding of ``csrc/interaction.cu`` (kernel K2).

``launch`` takes tensors that ``ops.dot_interaction`` / ``ops.gram`` have
already validated, enqueues the kernel on PyTorch's current stream without
synchronising, and raises if CUDA refused the launch.  ``launch_count``
rises by one per launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

# dynamic shared memory one block may use on sm_90 (the slab must fit)
MAX_SLAB_BYTES = 232_448

launch_count = 0
_count_lock = threading.Lock()
_fn = None


def slab_bytes(f: int, d: int) -> int:
    """Shared memory the kernel stages one sample in: F rows of float32,
    row stride padded to an odd word count."""
    return f * (d | 1) * 4


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().dot_interaction_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(feats: torch.Tensor, out: torch.Tensor, *, packed: bool) -> None:
    """feats (B, F, D), out (B, F(F-1)/2) or (B, F·F), contiguous on one
    CUDA device."""
    global launch_count
    b, f, d = feats.shape
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(feats.data_ptr(), out.data_ptr(), b, f, d, int(packed),
                          DTYPE_CODE[feats.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dot_interaction kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
