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
import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

# copies of csrc/cin.cu's constants (a test holds them equal): the block's
# rows, the K stage, the x and epilogue tiles' row strides, the w ring's
# least depth and the shared memory a block may have
BLOCK_M, SLICE_K = 128, 16
N_TILES = (8, 16, 32, 64, 128, 200)
X_STRIDE, E_STRIDE = BLOCK_M + 8, BLOCK_M + 4
MIN_STAGES, BARRIER_BYTES, SMEM_LIMIT = 2, 128, 232448
# split K until the blocks fill at least this share of one wave on the SMs
MIN_WAVE_SHARE = 0.9

launch_count = 0
_count_lock = threading.Lock()
_fns: dict = {}
_ARGTYPES = {
    "cin_layer_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "cin_split_w_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _function(name: str = "cin_layer_launch"):
    if name not in _fns:
        fn = getattr(_build.load(), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def n_tile(n: int) -> int:
    """The column tile (wgmma's n) a launch takes: N is cut into
    ceil(N / 200) tiles, each the smallest of ``N_TILES`` that holds its
    share (N = 200: one)."""
    tiles = -(-n // N_TILES[-1])
    return next(t for t in N_TILES if t >= -(-n // tiles))


def split_count(m: int, n: int, k: int, sm_count: int) -> int:
    """How many runs to cut the K = H·F reduction into: 1 when the
    (B·D, N) output's tiles already fill ``MIN_WAVE_SHARE`` of one wave
    (a block per SM), else enough runs to do so, at most one a stage of K
    (at B = 1 a block's stages wait for each other, so short runs are
    fastest)."""
    tiles = -(-m // BLOCK_M) * -(-n // n_tile(n))
    want = MIN_WAVE_SHARE * sm_count
    if tiles >= want:
        return 1
    return min(math.ceil(want / tiles), -(-k // SLICE_K))


def xk_rows(k: int, f: int, splits: int) -> int:
    """The most rows of xk (values of h) one run of K stages spans: what a
    block holds in shared memory (as csrc/cin.cu computes it)."""
    stages = -(-k // SLICE_K)
    per = -(-stages // splits)
    runs = -(-stages // per)
    return max((min((z + 1) * per * SLICE_K, k) - 1) // f - z * per * SLICE_K // f + 1
               for z in range(runs))


def shared_bytes(hr: int, f: int, nt: int) -> int:
    """A block's shared memory with ``MIN_STAGES`` w stages: the barriers,
    the ring of hi and lo planes, and the x tiles (or the epilogue tile
    over them, whichever is larger)."""
    return (BARRIER_BYTES + MIN_STAGES * 2 * SLICE_K * nt * 4
            + max((hr + f) * X_STRIDE, nt * E_STRIDE) * 4)


def plan(b: int, f: int, h: int, n: int, d: int, sm_count: int) -> tuple[int, int]:
    """(splits, n_tile) of a launch: ``split_count``'s runs, more if a
    run's x tiles would not fit a block's shared memory.  Raises
    ValueError when even a run of one stage does not fit (F too large)."""
    k = h * f
    nt = n_tile(n)
    splits = split_count(b * d, n, k, sm_count)
    stages = -(-k // SLICE_K)
    while shared_bytes(xk_rows(k, f, splits), f, nt) > SMEM_LIMIT:
        if splits >= stages:
            raise ValueError(f"a CIN layer of F={f} does not fit the kernel's shared memory "
                             f"({shared_bytes(xk_rows(k, f, splits), f, nt)} bytes needed, "
                             f"{SMEM_LIMIT} available)")
        splits += 1
    return splits, nt


def _planes(k: int, n: int, nt: int, device) -> torch.Tensor:
    """The workspace of w's TF32 planes: (column tiles, K stages, hi/lo,
    SLICE_K, nt) float32."""
    return torch.empty((-(-n // nt), -(-k // SLICE_K), 2, SLICE_K, nt), dtype=torch.float32,
                       device=device)


def split_w(w: torch.Tensor) -> torch.Tensor:
    """The kernel's pre-pass alone on a contiguous CUDA ``w`` (K, N): its
    TF32 hi and lo planes (``_planes``' shape), each (SLICE_K, nt) block
    laid out as wgmma's core matrices [k/4][n/8][n%8][k%4].  Not a K3
    launch (the count does not move): for timing the pre-pass's share and
    checking the planes."""
    k, n = w.shape
    nt = n_tile(n)
    wt = _planes(k, n, nt, w.device)
    with torch.cuda.device(w.device):
        err = _function("cin_split_w_launch")(w.data_ptr(), wt.data_ptr(), k, n, nt,
                                              DTYPE_CODE[w.dtype],
                                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cin_split_w kernel launch failed: CUDA error {err}")
    return wt


def launch(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """x0 (B, F, D), xk (B, H, D), w (H·F, N), out (B, N, D), contiguous,
    one dtype, on one CUDA device.  The float32 workspaces (w's TF32 hi and
    lo planes, and the partial sums when the reduction is split) are
    allocated here.  Raises ValueError for a shape the kernel cannot hold."""
    global launch_count
    b, f, d = x0.shape
    h = xk.shape[1]
    n = w.shape[1]
    splits, nt = plan(b, f, h, n, d, _sm_count(x0.device.index))
    # freed when this returns, before the kernels run: the caching allocator
    # hands the blocks out again only to work queued after them on this stream
    wt = _planes(h * f, n, nt, x0.device)
    partial = (torch.empty((splits, b, n, d), dtype=torch.float32, device=x0.device)
               if splits > 1 else None)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(x0.data_ptr(), xk.data_ptr(), w.data_ptr(), out.data_ptr(),
                          wt.data_ptr(), None if partial is None else partial.data_ptr(),
                          b, f, h, n, d, splits, nt, DTYPE_CODE[x0.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cin_layer kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
