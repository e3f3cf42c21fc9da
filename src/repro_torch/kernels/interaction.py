"""ctypes binding of ``csrc/interaction.cu`` (kernel K2 and its backward,
K2-bwd), and their plans.

``plan`` chooses how a launch is cut: samples a block, lanes a register
tile, threads, the slab's row stride and the shared-memory layout.  It is
plain arithmetic, tested on the CPU; the kernel trusts what it is given.
``launch`` takes tensors that ``ops.dot_interaction`` / ``ops.gram`` have
already validated, enqueues the kernel on PyTorch's current stream without
synchronising, and raises if CUDA refused the launch.  ``launch_count``
rises by one per launch and nowhere else; ``backward_plan``,
``launch_backward`` and ``backward_launch_count`` are the same for K2-bwd.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import DTYPE_CODE

TILE = 4                 # rows of i and of j in a thread's register tile (csrc's TILE)
MAX_SPLITS = 8           # most lanes that split one tile's d chunks (csrc's instantiations)
MAX_THREADS = 512        # a block's threads at most (csrc's MAX_THREADS)
# dynamic shared memory one block may use on sm_90 (the slab must fit)
MAX_SLAB_BYTES = 232_448
# a block takes consecutive samples until it holds this many tiles (F = 11:
# two samples; F = 41: one), while the grid keeps a block for every SM
TILES_PER_BLOCK = 12
# lanes split a tile's d chunks while the grid's work items stay within this
# many an SM: the split shortens a small batch's chain of loads and
# multiply-adds, and costs a full card its shuffles
WORK_PER_SM = 256

# rows and columns of dX a K2-bwd thread owns (csrc's BWD_ROWS, BWD_COLS):
# a block has ceil(F / BWD_ROWS) * ceil(D / BWD_COLS) threads, at most
# MAX_THREADS
BWD_ROWS = 4
BWD_COLS = 2
# samples a K2-bwd block holds in shared memory at once: the one it works on
# and the next, whose copies are in flight meanwhile (csrc's BWD_BUFFERS)
BWD_BUFFERS = 2
# what one SM of the card holds, for K2-bwd's wave: threads, shared memory
# (the CUDA driver reserves 1 KB a block), registers; and the registers a K2-bwd
# thread may take (csrc's __launch_bounds__(MAX_THREADS, 2): 65,536 / 1,024)
SM_THREADS = 2048
SM_SHARED_BYTES = 233_472
SM_REGISTERS = 65_536
BWD_REGISTERS = 64

launch_count = 0
backward_launch_count = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


class Plan(NamedTuple):
    samples: int         # S, consecutive samples a block
    splits: int          # KS, lanes that share one tile's d chunks
    threads: int         # a block's threads, a multiple of 32
    grid: int            # blocks, ceil(B / S)
    ld: int              # the slab's row stride in elements
    stage_at: int        # byte offset of the staged results, -1: written straight out
    smem: int            # dynamic shared memory of a block, bytes


def row_stride(d: int, itemsize: int) -> int:
    """A slab row's stride in elements: D rounded up to whole 16-byte
    chunks, and to an odd number of them (a quarter-warp's 16-byte reads of
    eight neighbouring rows then fall on different banks)."""
    chunks = -(-d * itemsize // 16) | 1
    return chunks * 16 // itemsize


def slab_bytes(f: int, d: int, itemsize: int = 4, samples: int = 1) -> int:
    """Shared memory the kernel stages ``samples`` samples in: F rows each,
    padded to whole row blocks of TILE."""
    return samples * -(-f // TILE) * TILE * row_stride(d, itemsize) * itemsize


def staged_bytes(f: int, d: int, itemsize: int, samples: int, n_out: int) -> int:
    """The slab, then the block's samples·n_out results, 16 bytes of slack
    in front of them to match the destination's offset modulo 16."""
    slab = slab_bytes(f, d, itemsize, samples)
    return -(-slab // 16) * 16 + 16 + samples * n_out * itemsize


@functools.lru_cache(maxsize=1024)
def plan(b: int, f: int, d: int, itemsize: int, packed: bool, sm_count: int) -> Plan:
    """How to launch K2 on feats (B, F, D) of ``itemsize``-byte elements on a
    card of ``sm_count`` SMs.  Raises ValueError, naming shared memory, when
    one sample's slab does not fit a block.

    Two regimes.  When the card is far from full (small B), lanes split each
    tile's d chunks (KS up to 8), the block gets a thread for each 16-byte
    chunk of its slab as well, so that each issues one copy, and results go
    straight to device memory.  When it is full, a lane takes a whole tile
    and the block stages its results and stores them as one range.  On an
    H100 the staging pass costs a small batch more than it saves and a full
    card less (chip_smoke.py times the flipped choice beside the plan's)."""
    need = slab_bytes(f, d, itemsize)
    if need > MAX_SLAB_BYTES:
        raise ValueError(f"a sample of F={f}, D={d} needs {need} bytes of shared memory; "
                         f"a block has {MAX_SLAB_BYTES}")
    rb = -(-f // TILE)
    tiles = rb * (rb + 1) // 2
    n_out = f * (f - 1) // 2 if packed else f * f
    s = max(1, min(TILES_PER_BLOCK // max(tiles, 1), b // sm_count))
    while s > 1 and staged_bytes(f, d, itemsize, s, n_out) > MAX_SLAB_BYTES:
        s -= 1
    grid = -(-b // s)
    chunks = -(-d * itemsize // 16)
    ks = 1
    while (ks < MAX_SPLITS and 2 * ks <= chunks and s * tiles * 2 * ks <= MAX_THREADS
           and grid * s * tiles * 2 * ks <= sm_count * WORK_PER_SM):
        ks *= 2
    work = s * tiles * ks
    if ks > 1:
        work = max(work, s * f * chunks)
    threads = -(-min(work, MAX_THREADS) // 32) * 32
    slab = slab_bytes(f, d, itemsize, s)
    staged = ks == 1 and staged_bytes(f, d, itemsize, s, n_out) <= MAX_SLAB_BYTES
    return Plan(samples=s, splits=ks, threads=threads, grid=grid, ld=row_stride(d, itemsize),
                stage_at=-(-slab // 16) * 16 if staged else -1,
                smem=staged_bytes(f, d, itemsize, s, n_out) if staged else slab)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _function():
    global _fn
    if _fn is None:
        fn = _build.load().dot_interaction_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 12
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def copy_path(d: int, itemsize: int, data_ptr: int) -> tuple[bool, int]:
    """(vec, elements a thread moves per slab row): 16-byte copies when the
    input starts on a 16-byte boundary and a row is whole 16-byte chunks,
    else masked scalars over D rounded up to whole chunks."""
    ch = 16 // itemsize
    chunks = -(-d // ch)
    vec = d % ch == 0 and data_ptr % 16 == 0
    return vec, chunks if vec else chunks * ch


@functools.lru_cache(maxsize=256)
def reciprocal(d: int) -> float:
    """1/d rounded to float32, as the kernel's divisor takes it."""
    return float(np.float32(1.0) / np.float32(max(d, 1)))


def launch(feats: torch.Tensor, out: torch.Tensor, p: Plan, *, packed: bool) -> None:
    """feats (B, F, D), out (B, F(F-1)/2) or (B, F·F), contiguous on one
    CUDA device; ``p`` is ``plan``'s for this shape."""
    global launch_count
    b, f, d = feats.shape
    vec, per_row = copy_path(d, feats.element_size(), feats.data_ptr())
    rb = -(-f // TILE)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function()(feats.data_ptr(), out.data_ptr(), b, f, d, int(packed),
                          DTYPE_CODE[feats.dtype], p.samples, p.splits, p.threads, p.ld,
                          p.stage_at, p.smem, int(vec), reciprocal(per_row), reciprocal(f),
                          reciprocal(rb * (rb + 1) // 2), stream)
    if err != 0:
        raise RuntimeError(f"dot_interaction kernel launch failed: CUDA error {err}")
    with _count_lock:
        launch_count += 1


class BackwardPlan(NamedTuple):
    buffers: int         # samples a block holds at once (BWD_BUFFERS)
    threads: int         # a block's threads, a multiple of 32
    grid: int            # blocks, about one wave; block k takes samples k, k + grid, ...
    smem: int            # dynamic shared memory of a block, bytes


def backward_table_bytes(f: int) -> int:
    """Shared memory K2-bwd keeps for the whole launch: G, the unpacked
    (F rounded up to BWD_ROWS) x F matrix in float32 at a row stride of F
    rounded up to 4, and the pair-index table of the same shape."""
    return 2 * -(-f // BWD_ROWS) * BWD_ROWS * -(-f // 4) * 4 * 4


def backward_sample_bytes(f: int, d: int, itemsize: int) -> int:
    """Shared memory one of K2-bwd's buffers takes: a sample's packed
    gradient and its (F, D) slab in their own type, each in whole 16-byte
    chunks with 32 bytes of slack (a range that starts off a boundary is
    copied from the boundary below)."""
    return sum(-(-n * itemsize // 16) * 16 + 32 for n in (f * (f - 1) // 2, f * d))


@functools.lru_cache(maxsize=1024)
def backward_plan(b: int, f: int, d: int, itemsize: int, sm_count: int) -> BackwardPlan:
    """How to launch K2-bwd on feats (B, F, D) of ``itemsize``-byte elements
    on a card of ``sm_count`` SMs: a thread for each BWD_COLS columns of each
    BWD_ROWS rows (at most MAX_THREADS), and as many blocks as the card holds at once
    by threads, registers and shared memory, but no more than B.  Raises
    ValueError, naming shared memory, when the table and BWD_BUFFERS samples
    do not fit a block."""
    smem = backward_table_bytes(f) + BWD_BUFFERS * backward_sample_bytes(f, d, itemsize)
    if smem > MAX_SLAB_BYTES:
        raise ValueError(f"K2-bwd at F={f}, D={d} needs {smem} bytes of shared memory for "
                         f"{BWD_BUFFERS} samples; a block has {MAX_SLAB_BYTES}")
    items = -(-f // BWD_ROWS) * -(-d // BWD_COLS)
    threads = -(-min(items, MAX_THREADS) // 32) * 32
    per_sm = max(1, min(SM_THREADS // threads, SM_REGISTERS // (threads * BWD_REGISTERS),
                        SM_SHARED_BYTES // (smem + 1024)))
    return BackwardPlan(buffers=BWD_BUFFERS, threads=threads,
                        grid=max(1, min(b, sm_count * per_sm)), smem=smem)


def work(b: int, f: int, d: int, itemsize: int,
         packed: bool = True) -> tuple[dict[str, float], float]:
    """K2's work at (B, F, D): (FLOPs by unit, bytes).  The features read
    once and the output (the strict lower triangle, or the whole Gram
    matrix unpacked) written once; 2·D float32 operations an output."""
    n_out = f * (f - 1) // 2 if packed else f * f
    return {"fp32": 2 * b * n_out * d}, b * (f * d + n_out) * itemsize


def backward_work(b: int, f: int, d: int, itemsize: int) -> tuple[dict[str, float], float]:
    """K2-bwd's work: features and packed gradient read once, the result
    written once; 2·D float32 operations for each ordered pair i != j."""
    n_out = f * (f - 1) // 2
    return {"fp32": 2 * b * f * (f - 1) * d}, b * (2 * f * d + n_out) * itemsize


def _backward_function():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().dot_interaction_backward_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def launch_backward(grad: torch.Tensor, feats: torch.Tensor, out: torch.Tensor,
                    p: BackwardPlan) -> None:
    """grad (B, F(F-1)/2), feats and out (B, F, D), one dtype, contiguous on
    one CUDA device; ``p`` is ``backward_plan``'s for this shape.  Inputs
    that start off a 16-byte boundary take the kernel's scalar copy path."""
    global backward_launch_count
    b, f, d = feats.shape
    vec = grad.data_ptr() % 16 == 0 and feats.data_ptr() % 16 == 0
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_function()(grad.data_ptr(), feats.data_ptr(), out.data_ptr(), b, f, d,
                                   DTYPE_CODE[feats.dtype], p.grid, p.threads, p.smem,
                                   int(vec), stream)
    if err != 0:
        raise RuntimeError(f"dot_interaction backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        backward_launch_count += 1
