"""ctypes binding of ``csrc/decode_attention.cu`` (kernel K4, flash-decode
attention of one new token against a KV cache).

``launch`` takes tensors that ``ops.decode_attention`` has already
validated, enqueues the kernel on PyTorch's current stream without
synchronising, and raises if CUDA refused the launch.  ``launch_count``
rises by one per launch and nowhere else (a split launch, main kernel and
combine of the runs, counts once).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

# what csrc/decode_attention.cu is instantiated for
HEAD_DIMS = (8, 16, 32, 64, 96, 128)
GROUPS = (1, 2, 4, 7, 8)
# a slot row of at most this many bytes gets the wide tile (TT in the source)
WIDE_ROW_BYTES = 256
WIDE_TILE, NARROW_TILE = 128, 64
# once B·Hkv blocks leave an SM idle, each sequence's slots are split into
# runs until every SM has this many blocks
BLOCKS_PER_SM = 2
# a run is at least this many tiles, so the combine stays small
MIN_TILES_PER_SPLIT = 2

launch_count = 0
_count_lock = threading.Lock()
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tile_slots(head_dim: int, element_size: int) -> int:
    """Slots of K (and of V) a block stages per tile."""
    return WIDE_TILE if head_dim * element_size <= WIDE_ROW_BYTES else NARROW_TILE


def split_count(batch: int, n_kv_heads: int, max_len: int, tile: int, sm_count: int) -> int:
    """How many runs to cut each sequence's slots into: 1 when the
    ``batch · n_kv_heads`` blocks already give every SM one, else enough
    runs for ``BLOCKS_PER_SM`` blocks on every SM, each run of at least
    ``MIN_TILES_PER_SPLIT`` tiles of the cache's ``max_len`` slots (the
    host does not read ``pos``)."""
    pairs = batch * n_kv_heads
    if pairs >= sm_count:
        return 1
    tiles = -(-max_len // tile)
    return max(1, min(-(-BLOCKS_PER_SM * sm_count // pairs), tiles // MIN_TILES_PER_SPLIT))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
           out: torch.Tensor) -> None:
    """q (B, Hq, D), k/v (B, T, Hkv, D), pos (B,) int32, out (B, Hq, D),
    contiguous, 16-byte aligned, on one CUDA device.  A float32 workspace
    for the runs' partial results is allocated here when the slots are
    split."""
    global launch_count
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    tile = tile_slots(d, k.element_size())
    splits = split_count(b, hkv, t, tile, _sm_count(q.device.index))
    # freed when this returns, before the kernels run: the caching allocator
    # hands the blocks out again only to work queued after them on this stream
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, hkv, splits, g, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hkv, splits, g, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                          out.data_ptr(),
                          None if part_acc is None else part_acc.data_ptr(),
                          None if part_ml is None else part_ml.data_ptr(),
                          b, t, hkv, g, d, splits, DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
