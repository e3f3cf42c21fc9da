"""ctypes binding of ``csrc/cin.cu`` (kernel K3, one xDeepFM CIN layer) and
of ``csrc/cin_backward.cu`` (K3-bwd, its gradient).

``launch`` takes tensors that ``ops.cin_layer`` has already validated,
enqueues the kernel on PyTorch's current stream without synchronising, and
raises if CUDA refused the launch.  ``launch_count`` rises by one per
launch and nowhere else (a split launch, main kernel and sum of the
partials, counts once).  ``launch_backward`` and
``backward_launch_count`` are the same for K3-bwd (its data and weight
products and the sums of their runs count once).
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
# block's tile of outputs, the reduction values a stage, the row strides of
# a stage's tiles and of P's staging tile, and the float32 values of the
# two stages' operands
BWD_TILE, BWD_STAGE = 128, 8
BWD_LD, BWD_PS = BWD_TILE + 4, BWD_TILE // 2 + 4
# K3-bwd cuts its products into runs until a launch has at least two waves
# of blocks, a wave being BWD_SLOTS blocks (two a SM on an H100's 132); a
# constant, so that the runs, and with them the order of every sum, depend
# on the shapes alone
BWD_SLOTS = 264
BWD_TARGET_BLOCKS = 2 * BWD_SLOTS
BWD_MIN_RUN = 256            # rows of the weight gradient a run, at least

launch_count = 0
backward_launch_count = 0
_count_lock = threading.Lock()
_fns: dict = {}
_ARGTYPES = {
    "cin_layer_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "cin_split_w_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "cin_layer_backward_launch": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
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
    float32 plane of dx0 when there is more than one), the weight
    gradient's M = B·D rows into ``weight_splits`` runs of ``row_run`` (a
    multiple of ``BWD_STAGE``; a float32 plane of dw each when more than
    one).  No run is empty."""
    data_splits: int
    h_run: int
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
    chunks of ``BWD_TILE``), at most H runs; for the weight gradient the
    last wave's idle slots, runs of at least ``BWD_MIN_RUN`` rows, a whole
    number of stages each.  Ties go to fewer runs.  Raises ValueError when
    F is too large for a block's shared memory."""
    if backward_shared_bytes(f) > SMEM_LIMIT:
        raise ValueError(f"K3-bwd at F={f} needs {backward_shared_bytes(f)} bytes of shared "
                         f"memory a block; it has {SMEM_LIMIT}")
    m, k = b * d, h * f
    row_tiles = max(1, -(-m // BWD_TILE))
    h_run = h
    if row_tiles < BWD_TARGET_BLOCKS:
        lo = min(h, -(-BWD_TARGET_BLOCKS // row_tiles))

        def data_share(hr: int) -> float:
            cols = hr * f
            return _wave_share(row_tiles * -(-h // hr)) * cols / (-(-cols // BWD_TILE) * BWD_TILE)
        h_run = max(sorted({-(-h // s) for s in range(lo, min(h, 4 * lo) + 1)}, reverse=True),
                    key=data_share)

    def rows_of(runs: int) -> tuple[int, int]:              # (runs, rows a run): whole stages
        run = max(1, -(-(-(-m // runs)) // BWD_STAGE)) * BWD_STAGE
        return max(1, -(-m // run)), run
    weight_tiles = -(-k // BWD_TILE) * max(1, -(-n // BWD_TILE))
    cap = max(1, m // BWD_MIN_RUN)
    lo = min(cap, -(-BWD_TARGET_BLOCKS // weight_tiles))
    weight_splits, row_run = max((rows_of(s) for s in range(lo, min(cap, 4 * lo) + 1)),
                                 key=lambda p: _wave_share(weight_tiles * p[0]))
    return BackwardPlan(-(-h // h_run), h_run, weight_splits, row_run)


def backward_error_bound(b: int, f: int, h: int, n: int, d: int) -> dict[str, float]:
    """The factor c of each of K3-bwd's gradients against its float64 value,
    |got - exact| <= c · Σ|terms| (each term a product of three float32
    factors, rounded twice), as gamma_L (u = 2^-24) of the longest chain of
    roundings a result meets: dxk's N products summed into P, then its F
    terms; dx0's N, then its H terms within a run of h, then the runs; dw's
    rows of a run, then the runs (``backward_plan``)."""
    p = backward_plan(b, f, h, n, d)
    u = 2.0 ** -24

    def gamma(chain: int) -> float:
        return chain * u / (1 - chain * u)
    return {"dx0": gamma(n + h + p.data_splits + 3), "dxk": gamma(n + f + 3),
            "dw": gamma(p.row_run + p.weight_splits + 3)}


def backward_shared_bytes(f: int) -> int:
    """The data gradient's shared memory a block: two stages of both
    operands, P's staging tile, and x0's tile and dx0's sums (F rows of
    ``BWD_TILE`` each)."""
    return (4 * BWD_STAGE * BWD_LD + BWD_TILE * BWD_PS + 2 * f * BWD_TILE) * 4


def backward_scratch(p: BackwardPlan, b: int, f: int, h: int, n: int,
                     d: int) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The float32 workspaces of a launch, by name: the planes of dx0's and
    dw's runs, where there is more than one."""
    out = {}
    if p.data_splits > 1:
        out["dx0_partial"] = ((p.data_splits, b, f, d), torch.float32)
    if p.weight_splits > 1:
        out["dw_partial"] = ((p.weight_splits, h * f, n), torch.float32)
    return out


def backward_work(b: int, f: int, h: int, n: int, d: int,
                  itemsize: int) -> tuple[dict[str, float], float]:
    """K3-bwd's work at g (B, N, D), x0 (B, F, D), xk (B, H, D), w (H·F, N):
    (FLOPs by unit, bytes).  g, x0, xk, w read once and dx0, dxk, dw written
    once; float32 on the CUDA cores: the data product 2·M·N·K and its two
    contractions 4·M·K, the weight product 2·M·K·N and forming A, M·K
    (M = B·D, K = H·F)."""
    m, k = b * d, h * f
    flops = 2 * m * n * k + 4 * m * k + 2 * m * k * n + m * k
    return {"fp32": flops}, (b * n * d + 2 * (b * f * d + b * h * d + k * n)) * itemsize


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
            dxk.data_ptr(), dw.data_ptr(), ptr.get("dx0_partial"), ptr.get("dw_partial"),
            b, f, h, n, d, plan.data_splits, plan.h_run, plan.weight_splits, plan.row_run,
            DTYPE_CODE[x0.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cin_layer backward kernel launch failed: CUDA error {err}")
    with _count_lock:
        backward_launch_count += 1
