"""ctypes binding of ``csrc/cin.cu`` (kernel K3, one xDeepFM CIN layer) and
of ``csrc/cin_backward.cu`` (K3-bwd, its gradient).

``launch`` takes tensors that ``ops.cin_layer`` has already validated,
enqueues the kernel on PyTorch's current stream without synchronising, and
raises if CUDA refused the launch.  ``launch_count`` rises by one per
launch and nowhere else (a split launch, main kernel and sum of the
partials, counts once).  ``launch_backward`` and
``backward_launch_count`` are the same for K3-bwd (its pre-passes, its data
and weight products and the sums of their runs count once).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

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

# copies of csrc/cin_backward.cu's constants (a test holds them equal): a
# block's rows, the reduction values a stage, the data product's chunks of
# columns m (the widest whose block fits), the row stride of the data
# kernel's g tile, the column stride of P's tile (a whole chunk) and the row
# stride of a stage's x rows; the rings' least depth and the barriers are
# K3's MIN_STAGES and BARRIER_BYTES
BWD_BLOCK, BWD_STAGE, BWD_CHUNKS = 128, 16, (64, 32)
BWD_G_STRIDE = BWD_BLOCK + 8
BWD_P_STRIDE = BWD_BLOCK + 4
BWD_X_STRIDE = BWD_STAGE + 4
# K3-bwd cuts its products into runs until a launch has at least two waves
# of blocks, a wave being BWD_SLOTS blocks (one a SM on an H100's 132); a
# constant, so that the runs, and with them the order of every sum, depend
# on the shapes alone
BWD_SLOTS = 132
BWD_TARGET_BLOCKS = 2 * BWD_SLOTS
BWD_MIN_RUN = 256            # rows of the weight gradient a run, at least

launch_count = 0
backward_launch_count = 0
_count_lock = threading.Lock()
_fns: dict = {}
_ARGTYPES = {
    "cin_layer_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "cin_split_w_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "cin_layer_backward_launch": ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]),
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


def work(b: int, f: int, h: int, n: int, d: int,
         itemsize: int) -> tuple[dict[str, float], float]:
    """K3's work at x0 (B, F, D), xk (B, H, D), w (H·F, N): (FLOPs by unit,
    bytes).  x0, xk, w read once and the (B, N, D) output written once; the
    product of M = B·D rows, K = H·F and N columns in three TF32 passes on
    the tensor cores (3 × 2·M·K·N)."""
    k = h * f
    return {"tf32": 3 * 2 * b * d * k * n}, (b * f * d + b * h * d + k * n + b * n * d) * itemsize


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


class BackwardPlan(NamedTuple):
    """How K3-bwd cuts its two products: the data gradient's h values into
    ``data_splits`` runs of ``h_run`` (each run writes its own dxk and a
    float32 plane of dx0 when there is more than one) and its columns into
    chunks of ``chunk`` (one of ``BWD_CHUNKS``), the weight gradient's
    M = B·D rows into ``weight_splits`` runs of ``row_run`` (a multiple of
    ``BWD_STAGE``; a float32 plane of dw each when more than one).  No run
    is empty."""
    data_splits: int
    h_run: int
    chunk: int
    weight_splits: int
    row_run: int


def _wave_share(blocks: int) -> float:
    """The share of a launch's waves of ``BWD_SLOTS`` blocks that its
    ``blocks`` fill (the last wave's idle slots are the rest)."""
    return blocks / (-(-blocks // BWD_SLOTS) * BWD_SLOTS)


def backward_plan(b: int, f: int, h: int, n: int, d: int) -> BackwardPlan:
    """K3-bwd's runs at x0 (B, F, D), xk (B, H, D), w (H·F, N), from the
    shapes alone (csrc/cin_backward.cu checks them).  Each product with
    fewer than ``BWD_TARGET_BLOCKS`` tiles is cut into between the fewest
    runs that reach it and four times as many, the count that wastes the
    least: for the data gradient the last wave's idle slots and the unused
    columns of a run's last chunk of P (a run of h values is h·F columns in
    chunks of the widest of ``BWD_CHUNKS`` whose block fits), at most H
    runs; for the weight gradient (tiles of ``BWD_BLOCK`` rows m by
    ``n_tile(N)`` columns) the last wave's idle slots, runs of at least
    ``BWD_MIN_RUN`` rows, a whole number of stages each.  Ties go to fewer
    runs.  Raises ValueError when F and N are too
    large for a block's shared memory."""
    fits = [c for c in BWD_CHUNKS if backward_shared_bytes(f, h, n, c) <= SMEM_LIMIT]
    if not fits:
        need = backward_shared_bytes(f, h, n, BWD_CHUNKS[-1])
        raise ValueError(f"K3-bwd at F={f}, N={n} needs {need} bytes of shared memory a "
                         f"block; it has {SMEM_LIMIT}")
    chunk = fits[0]
    m, k = b * d, h * f
    row_tiles = max(1, -(-m // BWD_BLOCK))
    h_run = h
    if row_tiles < BWD_TARGET_BLOCKS:
        lo = min(h, -(-BWD_TARGET_BLOCKS // row_tiles))

        def data_share(hr: int) -> float:
            cols = hr * f
            return _wave_share(row_tiles * -(-h // hr)) * cols / (-(-cols // chunk) * chunk)
        h_run = max(sorted({-(-h // s) for s in range(lo, min(h, 4 * lo) + 1)}, reverse=True),
                    key=data_share)

    def rows_of(runs: int) -> tuple[int, int]:              # (runs, rows a run): whole stages
        run = max(1, -(-(-(-m // runs)) // BWD_STAGE)) * BWD_STAGE
        return max(1, -(-m // run)), run
    weight_tiles = -(-k // BWD_BLOCK) * max(1, -(-n // n_tile(n)))
    cap = max(1, m // BWD_MIN_RUN)
    lo = min(cap, -(-BWD_TARGET_BLOCKS // weight_tiles))
    weight_splits, row_run = max((rows_of(s) for s in range(lo, min(cap, 4 * lo) + 1)),
                                 key=lambda p: _wave_share(weight_tiles * p[0]))
    return BackwardPlan(-(-h // h_run), h_run, chunk, weight_splits, row_run)


# the least relative error of one float32 rounding to nearest, and of one
# addition on the tensor cores, whose adder aligns by truncation
_U_NEAREST, _U_TRUNCATED = 2.0 ** -24, 2.0 ** -23


def _gamma(chain: int, u: float) -> float:
    return chain * u / (1 - chain * u)


def backward_error_bound(b: int, f: int, h: int, n: int, d: int) -> dict[str, float]:
    """The factor c of each of K3-bwd's gradients against its float64 value,
    |got - exact| <= c · Σ|terms| (a term of dxk is g·w·x0, of dx0 g·w·xk,
    of dw xk·x0·g).

    Both products run in 3xTF32 (csrc/cin_backward.cu), as K3 does
    (``chip_smoke.cin_float64_bound``).  A term's factors x = x_hi + x_lo +
    δx, x_hi = tf32(x), x_lo = tf32(x - x_hi): |x - x_hi| <= 2^-11 |x|,
    |δx| <= 2^-22 |x|; the dropped lo·lo and the two remainders are each at
    most 2^-22 of the term, so hi·lo + lo·hi + hi·hi represent it within
    r = 3·2^-22 (1 + 2^-10); the weight product's A = xk·x0 is rounded once
    to float32 first (r + 2^-24 (1 + 2^-10)).  The products of two TF32
    values are exact in float32.  Summed: a stage of ``BWD_STAGE``
    reduction values is six wgmma from a zero accumulator, 3·BWD_STAGE
    additions on the tensor cores at most in a term's chain; the stages'
    sums are added to a float32 total in order (one addition a stage, N/16
    of them for P, a run's rows/16 for dw), and dw's runs' planes once more
    each: gamma_L of that chain L with u = 2^-23 (every addition counted as
    a truncated one).  P then meets the contractions on the CUDA cores: a
    product and an addition (two roundings, u = 2^-24) a term, F terms for
    dxk, a run's h values for dx0 and its runs' planes once more each, on
    values already within c_P of theirs:
    c = c_P + (1 + c_P) · gamma_{2·terms + runs + 1} (u = 2^-24)."""
    p = backward_plan(b, f, h, n, d)
    rep = 3 * 2.0 ** -22 * (1 + 2.0 ** -10)
    stage_chain = 3 * BWD_STAGE
    c_p = rep + _gamma(stage_chain + -(-n // BWD_STAGE), _U_TRUNCATED)

    def contracted(terms: int, runs: int) -> float:
        return c_p + (1 + c_p) * _gamma(2 * terms + runs + 1, _U_NEAREST)
    c_dw = (rep + 2.0 ** -24 * (1 + 2.0 ** -10)
            + _gamma(stage_chain + p.row_run // BWD_STAGE + p.weight_splits + 1, _U_TRUNCATED))
    return {"dx0": contracted(p.h_run, p.data_splits), "dxk": contracted(f, 1), "dw": c_dw}


def backward_shared_bytes(f: int, h: int, n: int, chunk: int) -> int:
    """The data kernel's shared memory a block with ``MIN_STAGES`` w stages
    of ``chunk`` columns: the barriers, the ring, g's tile (N rounded up to
    whole stages, by ``BWD_G_STRIDE``), P's tile (the chunk's columns, by
    ``BWD_P_STRIDE``), x0's tile and dx0's sums (F rows of ``BWD_BLOCK``
    each) and two buffers of a chunk's xk rows (the most h a chunk spans,
    for each of the block's stages of rows).  The weight kernel's ring of g
    planes and x rows needs less at every shape the data kernel takes."""
    g_rows = -(-n // BWD_STAGE) * BWD_STAGE
    xk_rows = min(h, (chunk - 1) // f + 2)
    return (BARRIER_BYTES + MIN_STAGES * 2 * BWD_STAGE * chunk * 4
            + (g_rows * BWD_G_STRIDE + chunk * BWD_P_STRIDE + 2 * f * BWD_BLOCK
               + 2 * (BWD_BLOCK // BWD_STAGE) * xk_rows * BWD_X_STRIDE) * 4)


def backward_scratch(p: BackwardPlan, b: int, f: int, h: int, n: int,
                     d: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The float32 workspaces of a launch, by name: w's planes for the data
    product (runs, chunks a run, n stages, hi/lo, ``BWD_STAGE``, the
    plan's chunk), g's planes for the weight product (column tiles, r
    stages, hi/lo, ``BWD_STAGE``, ``n_tile(N)``), x's rows (r stages, H +
    F, ``BWD_X_STRIDE``), and the planes of dx0's and dw's runs, where there
    is more than one."""
    r_stages = -(-(b * d) // BWD_STAGE)
    nt = n_tile(n)
    out = {"w_planes": ((p.data_splits, -(-p.h_run * f // p.chunk), -(-n // BWD_STAGE), 2,
                         BWD_STAGE, p.chunk), torch.float32),
           "g_planes": ((-(-n // nt), r_stages, 2, BWD_STAGE, nt), torch.float32),
           "x_rows": ((r_stages, h + f, BWD_X_STRIDE), torch.float32)}
    if p.data_splits > 1:
        out["dx0_partial"] = ((p.data_splits, b, f, d), torch.float32)
    if p.weight_splits > 1:
        out["dw_partial"] = ((p.weight_splits, h * f, n), torch.float32)
    return out


def backward_work(b: int, f: int, h: int, n: int, d: int,
                  itemsize: int) -> tuple[dict[str, float], float]:
    """K3-bwd's work at g (B, N, D), x0 (B, F, D), xk (B, H, D), w (H·F, N):
    (FLOPs by unit, bytes).  g, x0, xk, w read once and dx0, dxk, dw written
    once; the data product 2·M·N·K and the weight product 2·M·K·N in three
    TF32 passes each on the tensor cores, the data gradient's two
    contractions 4·M·K and forming A, M·K, float32 on the CUDA cores
    (M = B·D, K = H·F)."""
    m, k = b * d, h * f
    return ({"tf32": 3 * (2 * m * n * k + 2 * m * k * n), "fp32": 4 * m * k + m * k},
            (b * n * d + 2 * (b * f * d + b * h * d + k * n)) * itemsize)


def launch_backward(g: torch.Tensor, x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                    dx0: torch.Tensor, dxk: torch.Tensor, dw: torch.Tensor, *,
                    plan: BackwardPlan, scratch: dict[str, torch.Tensor]) -> None:
    """g (B, N, D), x0 (B, F, D), xk (B, H, D), w (H·F, N) and the outputs
    dx0, dxk, dw (their inputs' shapes), contiguous, one dtype, on one CUDA
    device; ``plan`` is ``backward_plan``'s for these shapes and ``scratch``
    holds ``backward_scratch``'s workspaces."""
    global backward_launch_count
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    ptr = {k: v.data_ptr() for k, v in scratch.items()}
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _function("cin_layer_backward_launch")(
            g.data_ptr(), x0.data_ptr(), xk.data_ptr(), w.data_ptr(), dx0.data_ptr(),
            dxk.data_ptr(), dw.data_ptr(), ptr["w_planes"], ptr["g_planes"], ptr["x_rows"],
            ptr.get("dx0_partial"), ptr.get("dw_partial"),
            b, f, h, n, d, plan.data_splits, plan.h_run, plan.chunk, plan.weight_splits,
            plan.row_run, DTYPE_CODE[x0.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cin_layer backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        backward_launch_count += 1
