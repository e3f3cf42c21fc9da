"""ctypes binding of ``csrc/decode_attention.cu`` (kernel K4, flash-decode
attention of one new token against a KV cache), and its plan.

``plan`` chooses the run length: how many slots of a sequence one block
reads at most.  It is plain arithmetic, tested on the CPU; the kernel cuts
each sequence's valid slots (from ``pos``, on the card) into runs of that
length.  ``launch`` takes tensors that ``ops.decode_attention`` has already
validated, enqueues the kernel (and, when a sequence may have more than one
run, the combine of the runs) on PyTorch's current stream without
synchronising, and raises if CUDA refused a launch.  ``launch_count``
rises by one per call and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

# what csrc/decode_attention.cu is instantiated for
HEAD_DIMS = (8, 16, 32, 64, 96, 128)
GROUPS = (1, 2, 4, 7, 8)
# a slot row of at most this many bytes gets the wide tile (TT in the source)
WIDE_ROW_BYTES = 256
WIDE_TILE, NARROW_TILE = 128, 64
# a full cache is cut into runs until every SM has this many blocks
BLOCKS_PER_SM = 2
# runs are whole tiles, or below a tile whole multiples of a warp's slots
RUN_QUANTUM = 32
# no run is longer than this, so that the blocks of uneven caches stay short
# when B·Hkv alone fills the card
MAX_RUN_SLOTS = 4096
MAX_RUNS = 65_535        # the grid's third axis
# the combine's threads a block (kCombineThreads in the source), and the runs
# one of them walks at most where a narrower column block allows it
COMBINE_THREADS = 128
COMBINE_RUNS_PER_THREAD = 4

launch_count = 0
_count_lock = threading.Lock()
_fn = None


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class Plan(NamedTuple):
    tile: int            # slots a block stages per tile (TT in the source)
    run_slots: int       # slots one block reads at most
    runs: int            # the grid's third axis, ceil(T / run_slots); 1: no combine
    blocks: int          # B · Hkv · runs
    combine_cols: int    # columns of D a combine block takes (a multiple of 4 dividing D)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tile_slots(head_dim: int, element_size: int) -> int:
    """Slots of K (and of V) a block stages per tile."""
    return WIDE_TILE if head_dim * element_size <= WIDE_ROW_BYTES else NARROW_TILE


@functools.lru_cache(maxsize=1024)
def plan(batch: int, n_kv_heads: int, max_len: int, head_dim: int, element_size: int,
         sm_count: int) -> Plan:
    """How K4 cuts caches of ``max_len`` slots on a card of ``sm_count`` SMs.

    The host does not read ``pos``, so the run length is sized for full
    caches: enough runs that ``batch · n_kv_heads · runs`` blocks give every
    SM ``BLOCKS_PER_SM``, each run whole tiles (whole warps' slots when
    shorter than a tile) and at most ``MAX_RUN_SLOTS`` long.  On the card a
    sequence of ``pos`` slots then reads ``ceil(pos / run_slots)`` runs of
    this one length: the rest of its blocks exit at once."""
    tile = tile_slots(head_dim, element_size)
    pairs = max(1, batch * n_kv_heads)
    run = -(-max_len // -(-BLOCKS_PER_SM * sm_count // pairs))
    quantum = tile if run > tile else RUN_QUANTUM
    run = min(-(-run // quantum) * quantum, MAX_RUN_SLOTS)
    return cut(batch, n_kv_heads, max_len, head_dim, element_size, run)


def cut(batch: int, n_kv_heads: int, max_len: int, head_dim: int, element_size: int,
        run_slots: int) -> Plan:
    """The launch for runs of ``run_slots`` (at least ``max_len / MAX_RUNS``;
    one run when that covers ``max_len``).  The combine takes D in column
    blocks narrow enough that none of its threads walks more than
    ``COMBINE_RUNS_PER_THREAD`` runs, where a block of 4 columns does."""
    tile = tile_slots(head_dim, element_size)
    pairs = max(1, batch * n_kv_heads)
    run = max(run_slots, -(-max_len // MAX_RUNS))
    if run >= max_len:
        return Plan(tile=tile, run_slots=max_len, runs=1, blocks=pairs, combine_cols=head_dim)
    runs = -(-max_len // run)
    widest = COMBINE_THREADS * 4 * COMBINE_RUNS_PER_THREAD // runs
    cols = max(c for c in range(4, head_dim + 1, 4)
               if head_dim % c == 0 and (c <= widest or c == 4))
    return Plan(tile=tile, run_slots=run, runs=runs, blocks=pairs * runs, combine_cols=cols)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
           out: torch.Tensor, split: Plan | None = None) -> None:
    """q (B, Hq, D), k/v (B, T, Hkv, D), pos (B,) int32, out (B, Hq, D),
    contiguous, 16-byte aligned, on one CUDA device.  ``split`` None takes
    the plan's (another is for timing the plan against).  A float32
    workspace for the runs' partial results is allocated here when a
    sequence may have more than one run."""
    global launch_count
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if split is None:
        split = plan(b, hkv, t, d, k.element_size(), sm_count(q.device.index))
    runs = -(-t // split.run_slots)
    # freed when this returns, before the kernels run: the caching allocator
    # hands the blocks out again only to work queued after them on this stream
    part_acc = part_ml = None
    if runs > 1:
        part_acc = torch.empty((b, hkv, runs, g, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hkv, runs, g, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                          out.data_ptr(),
                          None if part_acc is None else part_acc.data_ptr(),
                          None if part_ml is None else part_ml.data_ptr(),
                          b, t, hkv, g, d, split.run_slots, split.combine_cols,
                          DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1
