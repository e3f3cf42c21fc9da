"""ctypes binding of ``csrc/cin.cu`` (kernel K3, one xDeepFM CIN layer).

``launch`` takes tensors that ``ops.cin_layer`` has already validated,
enqueues the kernel on PyTorch's current stream without synchronising, and
raises if CUDA refused the launch.  ``launch_count`` rises by one per
launch and nowhere else (a split launch, main kernel and sum of the
partials, counts once).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

# the kernel's block tile and K slice (BM, BN, BK in csrc/cin.cu)
BLOCK_M, BLOCK_N, SLICE_K = 64, 64, 16
# blocks wanted in flight on each SM before the K dimension is split
BLOCKS_PER_SM = 2
# a split walks at least this many K slices, so partial sums stay few
MIN_SLICES_PER_SPLIT = 4

launch_count = 0
_count_lock = threading.Lock()
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().cin_layer_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_count(m: int, n: int, k: int, sm_count: int) -> int:
    """How many runs to cut the K = H·F reduction into: 1 when the
    (B·D, N) output already gives every SM ``BLOCKS_PER_SM`` tiles, else
    enough runs to do so, each of at least ``MIN_SLICES_PER_SPLIT`` slices."""
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    target = BLOCKS_PER_SM * sm_count
    if tiles >= target:
        return 1
    slices = -(-k // SLICE_K)
    return max(1, min(-(-target // tiles), slices // MIN_SLICES_PER_SPLIT))


def launch(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """x0 (B, F, D), xk (B, H, D), w (H·F, N), out (B, N, D), contiguous,
    one dtype, on one CUDA device.  A float32 workspace for the partial
    sums is allocated here when the reduction is split."""
    global launch_count
    b, f, d = x0.shape
    h = xk.shape[1]
    n = w.shape[1]
    splits = split_count(b * d, n, h * f, _sm_count(x0.device.index))
    # freed when this returns, before the kernels run: the caching allocator
    # hands the block out again only to work queued after them on this stream
    partial = (torch.empty((splits, b, n, d), dtype=torch.float32, device=x0.device)
               if splits > 1 else None)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(x0.data_ptr(), xk.data_ptr(), w.data_ptr(), out.data_ptr(),
                          None if partial is None else partial.data_ptr(),
                          b, f, h, n, d, splits, DTYPE_CODE[x0.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cin_layer kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
