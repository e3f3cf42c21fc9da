"""ctypes binding of ``csrc/embedding_bag.cu`` (kernel K1).

``launch`` takes tensors that ``ops.embedding_bag`` has already validated,
enqueues the kernel on PyTorch's current stream without synchronising, and
raises if CUDA refused the launch.  ``launch_count`` rises by one per
launch and nowhere else, so a run can show it went through this kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
_count_lock = threading.Lock()
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().embedding_bag_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(tables: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, *,
           mean: bool) -> None:
    """tables (F, V, D), idx (B, F, H) int32, out (B, F, D), all contiguous
    on one CUDA device."""
    global launch_count
    f, v, d = tables.shape
    b, _, h = idx.shape
    row_bytes = d * tables.element_size()
    vectorized = (row_bytes % 16 == 0 and tables.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(tables.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          b * f, f, v, d, h, int(mean), DTYPE_CODE[tables.dtype],
                          int(vectorized), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
