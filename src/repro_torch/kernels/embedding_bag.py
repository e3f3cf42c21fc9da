"""ctypes binding of ``csrc/embedding_bag.cu``: kernel K1 and its
backward, K1-bwd.

``launch`` and ``launch_backward`` take tensors that ``ops`` has already
validated, enqueue the kernel on PyTorch's current stream without
synchronising, and raise if CUDA refused the launch.  ``launch_count`` and
``backward_launch_count`` rise by one per launch of their kernel and
nowhere else, so a run can show it went through them.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launch_count = 0
backward_launch_count = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


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


# K1-bwd: the most columns a lane sums (csrc's CPL instantiations: D <= 256)
MAX_BACKWARD_D = 256
# K1-bwd: the most warps that split one table's rows between them
MAX_BACKWARD_WARPS = 128


def backward_warps(f: int, sm_count: int) -> int:
    """log2 of W, the warps that own one table's rows in K1-bwd (warp w takes
    rows r with r % W == w; each scans all of the table's lookups): about 32
    warps an SM over the F tables, a power of two, at most 128."""
    w = 1
    while w * 2 <= min(MAX_BACKWARD_WARPS, sm_count * 32 // max(f, 1)):
        w *= 2
    return w.bit_length() - 1


def _backward_function():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().embedding_bag_backward_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


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


def launch_backward(grad_out: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor, *,
                    mean: bool, log_w: int) -> None:
    """grad_out (B, F, D) float32 or bfloat16, idx (B, F, H) int32, grad
    (F, V, D) float32 and zeroed, D <= MAX_BACKWARD_D, all contiguous on one
    CUDA device: adds every bag's gradient row into the rows it looked up,
    2^log_w warps owning each table's rows (``backward_warps``)."""
    global backward_launch_count
    f, v, d = grad.shape
    b, _, h = idx.shape
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_function()(grad_out.data_ptr(), idx.data_ptr(), grad.data_ptr(),
                                   b, f, v, d, h, log_w, int(mean),
                                   DTYPE_CODE[grad_out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        backward_launch_count += 1
