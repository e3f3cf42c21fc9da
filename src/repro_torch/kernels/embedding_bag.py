"""ctypes binding of ``csrc/embedding_bag.cu``: kernel K1 and its
backward, K1-bwd, and K1-bwd's plan.

``launch`` and ``launch_backward`` take tensors that ``ops`` has already
validated, enqueue their kernels on PyTorch's current stream without
synchronising, and raise if CUDA refused a launch.  ``launch_count`` and
``backward_launch_count`` rise by one per call of ``launch`` and
``launch_backward`` and nowhere else, so a run can show it went through
them.  K1-bwd is one call of ``launch_backward`` and one count, however
many CUDA kernels the call enqueues (its partition passes, the sum and the
combine).

``backward_plan`` cuts K1-bwd: the partition's passes and buckets, the
chunk of sorted lookups a lane group sums, the groups and the grid, the
division by H.  It is plain arithmetic, tested on the CPU; the kernels
trust it.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

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


# K1-bwd: the widest row it takes (csrc's CPV instantiations: D <= 256)
MAX_BACKWARD_D = 256
# the partition: a block's lookups a pass (csrc's SORT_THREADS * SORT_ITEMS)
# and the most bits a pass sorts by (csrc's MAX_DIGIT_BITS: 1,024 buckets)
SORT_TILE = 4096
MAX_DIGIT_BITS = 10
# the sum: a block's threads (csrc's SUM_THREADS); a lane group has at least
# MIN_GROUP lanes and at most a warp; a chunk (the sorted lookups one group
# sums) is a power of two in [MIN_CHUNK, MAX_CHUNK], about as many chunks as
# there are groups in RESIDENT_THREADS threads.  That count is fixed, an
# H100 SXM's 132 SMs of 2,048 threads, and not read from the card: the chunk
# decides how a hot row's sum is grouped, so the gradient's bits depend on
# the shapes alone, on any card.
SUM_THREADS = 256
MIN_GROUP = 8
MIN_CHUNK, MAX_CHUNK = 64, 2048
RESIDENT_THREADS = 132 * 2048
MAX_TABLES = 65_535          # the partition grid's second axis
MAX_LOOKUPS = 2 ** 31 - 1    # B * H of one table: int32 positions


class BackwardPlan(NamedTuple):
    passes: int          # LSD radix passes over each table's (row, bag) pairs
    digit_bits: int      # bits a pass sorts by: 2^digit_bits buckets
    tiles: int           # partition blocks a table and pass, SORT_TILE lookups each
    chunk: int           # sorted lookups a lane group sums
    chunks: int          # chunks a table
    group: int           # lanes of a group: G * vec columns a load
    vec: int             # columns a lane reads at once (16 bytes) or 1
    cpv: int             # vectors a lane holds of a row (csrc's CPV)
    blocks: int          # the sum's and the combine's blocks of SUM_THREADS: a group a chunk
    div_m: int           # b = (i * div_m) >> div_s is i // H for 0 <= i < 2^31
    div_s: int


def div_magic(d: int) -> tuple[int, int]:
    """(m, s) with (n * m) >> s == n // d for every 0 <= n < 2^31, m < 2^33:
    s = 31 + ceil(log2 d), m = 2^s // d + 1 (csrc's FastDiv)."""
    s = 31 + (d - 1).bit_length()
    return (1 << s) // d + 1, s


@functools.lru_cache(maxsize=1024)
def backward_plan(b: int, f: int, v: int, h: int, d: int, itemsize: int,
                  vectorized: bool) -> BackwardPlan:
    """How K1-bwd cuts grad_out (B, F, D) of ``itemsize``-byte elements and
    idx (B, F, H) into a (F, V, D) gradient; ``vectorized`` when
    grad_out's rows are read as 16-byte vectors (a row a whole number of
    them, from a 16-byte boundary).

    The partition sorts by ceil(log2 V) bits in as few passes of at most
    MAX_DIGIT_BITS as cover them, the bits split evenly.  A lane group
    takes 16 bytes of a row a lane (one element without ``vectorized``), as
    few lanes as cover the row but at least MIN_GROUP and at most 32.  The
    chunk is the power of two that gives about one chunk to each group in
    RESIDENT_THREADS threads, within [MIN_CHUNK, MAX_CHUNK]."""
    n = b * h
    if n > MAX_LOOKUPS or f > MAX_TABLES:
        raise ValueError(f"K1-bwd takes B*H <= {MAX_LOOKUPS} lookups a table and at most "
                         f"{MAX_TABLES} tables, got B*H = {n}, F = {f}")
    if d > MAX_BACKWARD_D:
        raise ValueError(f"the backward kernel takes D <= {MAX_BACKWARD_D}, got {d}")
    bits = max(1, (v - 1).bit_length())
    passes = -(-bits // MAX_DIGIT_BITS)
    vec = 16 // itemsize if vectorized else 1
    n_vec = max(1, d // vec)
    group = MIN_GROUP
    while group < n_vec and group < 32:
        group *= 2
    cpv = 1
    while cpv * group < n_vec:
        cpv *= 2
    resident = RESIDENT_THREADS // group
    chunk = MIN_CHUNK
    while chunk < MAX_CHUNK and f * n > chunk * resident:
        chunk *= 2
    chunks = max(1, -(-n // chunk))
    m, s = div_magic(max(h, 1))
    return BackwardPlan(passes=passes, digit_bits=-(-bits // passes),
                        tiles=max(1, -(-n // SORT_TILE)), chunk=chunk, chunks=chunks, group=group,
                        vec=vec, cpv=cpv, blocks=-(-f * chunks * group // SUM_THREADS),
                        div_m=m, div_s=s)


def backward_scratch(p: BackwardPlan, b: int, f: int, h: int, d: int) -> dict[str, tuple]:
    """The scratch one K1-bwd call takes, as (shape, dtype) by name: the
    partition's pairs (two buffers when it has more than one pass), its
    counts, the sum's head and tail of every chunk.  It depends on the
    shapes alone: about 16 bytes a lookup.  The counts are F x tiles x
    2^digit_bits, then each bucket's total, F x 2^digit_bits."""
    return {"pairs": ((2 if p.passes > 1 else 1, f * b * h), torch.int64),
            "counts": (((f << p.digit_bits) * (p.tiles + 1),), torch.int32),
            "partials": ((f * p.chunks, 2, d), torch.float32)}


def work(b: int, f: int, h: int, d: int, itemsize: int,
         rows: float | None = None) -> tuple[dict[str, float], float]:
    """K1's work at (B, F, H, D): (FLOPs by unit, bytes).  It reads ``rows``
    table rows (every lookup's, B·F·H, unless a run gives the count its
    data needs: distinct rows), the int32 ids once, and writes the (B, F, D)
    output once; its Kahan sums are four float32 additions a row element.
    The accounting (``ops`` on fake tensors) and ``chip_smoke.py``'s bounds
    both call it."""
    rows = b * f * h if rows is None else rows
    return {"fp32": 4 * b * f * h * d}, rows * d * itemsize + b * f * h * 4 + b * f * d * itemsize


def backward_work(b: int, f: int, h: int, d: int, itemsize: int,
                  rows: float | None = None) -> tuple[dict[str, float], float]:
    """K1-bwd's work: grad_out (B, F, D) and the ids read once, ``rows``
    float32 gradient rows stored once (every lookup's unless a run gives
    its distinct rows), one float32 addition a lookup's row element."""
    rows = b * f * h if rows is None else rows
    return {"fp32": b * f * h * d}, b * f * d * itemsize + b * f * h * 4 + rows * d * 4


def _backward_function():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load().embedding_bag_backward_launch
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 13
                       + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])
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


def backward_vectorized(grad_out: torch.Tensor) -> bool:
    """K1-bwd reads grad_out's rows as 16-byte vectors: a row is a whole
    number of them and the tensor starts on a 16-byte boundary."""
    return grad_out.shape[-1] * grad_out.element_size() % 16 == 0 and grad_out.data_ptr() % 16 == 0


def launch_backward(grad_out: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor, *,
                    mean: bool, plan: BackwardPlan, scratch: dict[str, torch.Tensor]) -> None:
    """grad_out (B, F, D) float32 or bfloat16, idx (B, F, H) int32, grad
    (F, V, D) float32 and zeroed, D <= MAX_BACKWARD_D, all contiguous on one
    CUDA device; ``plan`` is ``backward_plan``'s for these shapes and
    ``backward_vectorized(grad_out)``, ``scratch`` tensors of
    ``backward_scratch``'s shapes on the same device.  Adds every bag's
    gradient row into the rows it looked up: the partition, the sum and the
    combine, enqueued by one call and counted as one launch."""
    global backward_launch_count
    f, v, d = grad.shape
    b, _, h = idx.shape
    p = plan
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_function()(
            grad_out.data_ptr(), idx.data_ptr(), grad.data_ptr(), scratch["pairs"].data_ptr(),
            scratch["counts"].data_ptr(), scratch["partials"].data_ptr(), b, f, v, d, h,
            int(mean), DTYPE_CODE[grad_out.dtype], p.passes, p.digit_bits, p.tiles, p.chunk,
            p.chunks, p.group, p.vec, p.cpv, p.blocks, p.div_m, p.div_s, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        backward_launch_count += 1
