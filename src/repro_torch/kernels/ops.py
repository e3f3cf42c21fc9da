"""Public wrappers of the hand-written kernels.

Dispatch is by where the tensor lies, and by nothing else: a CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain version in
``ref``.  There is no switch that sends a CUDA tensor to the plain version
and no ``try`` that gives way to it.

The kernels mask their own edges, so nothing is padded here (odd batch
sizes and ``D = 130`` go straight through).  Each wrapper checks device,
dtype, shape and contiguity, allocates its output with ``torch.empty``,
launches on the current stream and does not synchronise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cin as _cin
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import interaction as _ix
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by this process since the last reset."""
    return {"embedding_bag": _eb.launch_count, "dot_interaction": _ix.launch_count,
            "cin_layer": _cin.launch_count, "decode_attention": _da.launch_count}


def reset_launch_counts() -> None:
    _eb.launch_count = 0
    _ix.launch_count = 0
    _cin.launch_count = 0
    _da.launch_count = 0


def _require_contiguous(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous, got strides {x.stride()}")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *, mode: str = "sum",
                  check_indices: bool = False) -> torch.Tensor:
    """Pooled lookup, float32 Kahan accumulation, result in the table's dtype.

    ``table (V, D)``, ``idx (B, H)`` → ``(B, D)``; or stacked
    ``table (F, V, D)``, ``idx (B, F, H)`` → ``(B, F, D)`` in one launch
    (field ``f`` looks up table ``f``).  ``idx`` is int32 or int64 on the
    CPU, int32 on the GPU.  ``check_indices`` verifies ``0 <= idx < V``
    first — a debugging aid that synchronises; the kernel trusts its indices.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    stacked = table.ndim == 3
    if table.ndim not in (2, 3) or idx.ndim != table.ndim:
        raise ValueError(f"expected table (V, D) with idx (B, H) or table (F, V, D) "
                         f"with idx (B, F, H); got {tuple(table.shape)}, {tuple(idx.shape)}")
    if stacked and idx.shape[1] != table.shape[0]:
        raise ValueError(f"idx has {idx.shape[1]} fields, table has {table.shape[0]}")
    if idx.shape[-1] < 1:
        raise ValueError("a bag needs at least one lookup")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported (float32, bfloat16)")
    if idx.device != table.device:
        raise ValueError(f"idx lies on {idx.device}, table on {table.device}")
    if check_indices and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= table.shape[-2]:
            raise IndexError(f"indices span [{lo}, {hi}], table has {table.shape[-2]} rows")

    if not table.is_cuda:
        if stacked:
            return ref.embedding_bag_stacked(table, idx, mode=mode)
        return ref.embedding_bag(table, idx, mode=mode)

    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32 on the GPU, got {idx.dtype}")
    _require_contiguous("table", table)
    _require_contiguous("idx", idx)
    tables3 = table if stacked else table[None]
    idx3 = idx if stacked else idx[:, None, :]
    out = torch.empty((idx3.shape[0], tables3.shape[0], tables3.shape[2]),
                      dtype=table.dtype, device=table.device)
    if out.numel():
        _eb.launch(tables3, idx3, out, mean=(mode == "mean"))
    return out if stacked else out[:, 0, :]


def _interaction(feats: torch.Tensor, *, packed: bool) -> torch.Tensor:
    if feats.ndim != 3:
        raise ValueError(f"expected feats (B, F, D), got {tuple(feats.shape)}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"feats dtype {feats.dtype} not supported (float32, bfloat16)")
    if not feats.is_cuda:
        return ref.dot_interaction_packed(feats) if packed else ref.gram(feats)
    _require_contiguous("feats", feats)
    b, f, d = feats.shape
    if _ix.slab_bytes(f, d) > _ix.MAX_SLAB_BYTES:
        raise ValueError(f"a sample of F={f}, D={d} needs {_ix.slab_bytes(f, d)} bytes of "
                         f"shared memory; a block has {_ix.MAX_SLAB_BYTES}")
    n_out = f * (f - 1) // 2 if packed else f * f
    out = torch.empty((b, n_out), dtype=feats.dtype, device=feats.device)
    if out.numel():
        _ix.launch(feats, out, packed=packed)
    return out


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F(F-1)/2): the strict lower triangle of each
    sample's Gram matrix in ``np.tril_indices(F, -1)`` order, float32
    accumulation, result in the input's dtype."""
    return _interaction(feats, packed=True)


def gram(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F·F) flattened Gram matrices."""
    return _interaction(feats, packed=False)


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One xDeepFM CIN layer: x0 (B, F, D), xk (B, H, D), w (H·F, Hn) →
    (B, Hn, D), ``out[b, n, d] = Σ_{h,f} w[h·F+f, n] · xk[b,h,d] · x0[b,f,d]``;
    float32 accumulation, result in the inputs' dtype.  Neither ``D`` nor
    the batch is padded."""
    if x0.ndim != 3 or xk.ndim != 3 or w.ndim != 2:
        raise ValueError(f"expected x0 (B, F, D), xk (B, H, D), w (H·F, Hn); got "
                         f"{tuple(x0.shape)}, {tuple(xk.shape)}, {tuple(w.shape)}")
    b, f, d = x0.shape
    h = xk.shape[1]
    if xk.shape[0] != b or xk.shape[2] != d:
        raise ValueError(f"xk {tuple(xk.shape)} does not share B and D with x0 {tuple(x0.shape)}")
    if f < 1 or h < 1:
        raise ValueError(f"a CIN layer needs at least one field and one map, got F={f}, H={h}")
    if w.shape[0] != h * f:
        raise ValueError(f"w has {w.shape[0]} rows, H·F = {h}·{f} = {h * f}")
    if x0.dtype not in _DTYPES or xk.dtype != x0.dtype or w.dtype != x0.dtype:
        raise TypeError(f"x0, xk, w must share one dtype of float32/bfloat16, got "
                        f"{x0.dtype}, {xk.dtype}, {w.dtype}")
    if xk.device != x0.device or w.device != x0.device:
        raise ValueError(f"x0 lies on {x0.device}, xk on {xk.device}, w on {w.device}")
    if not x0.is_cuda:
        return ref.cin_layer(x0, xk, w)
    for name, t in (("x0", x0), ("xk", xk), ("w", w)):
        _require_contiguous(name, t)
    out = torch.empty((b, w.shape[1], d), dtype=x0.dtype, device=x0.device)
    if out.numel():
        _cin.launch(x0, xk, w, out)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """One query token per sequence against its KV cache: q (B, Hq, D),
    k/v (B, T, Hkv, D), pos (B,) → (B, Hq, D).  Query head ``h·G + g``
    (G = Hq / Hkv) reads KV head ``h``; slots ``t >= pos[b]`` are masked
    (all of them for ``pos <= 0``, which gives the mean of V).  float32
    inside, result in q's dtype.  ``pos`` is int32 on the GPU; the kernel
    takes D in ``HEAD_DIMS`` and G in ``GROUPS`` of ``kernels.decode_attention``."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape or pos.ndim != 1:
        raise ValueError(f"expected q (B, Hq, D), k and v (B, T, Hkv, D), pos (B,); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, {tuple(pos.shape)}")
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or pos.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and pos {tuple(pos.shape)} "
                         f"do not share B and D")
    if t < 1 or hkv < 1 or hq % hkv != 0:
        raise ValueError(f"need T >= 1 and Hq a multiple of Hkv, got T={t}, Hq={hq}, Hkv={hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"pos must be an integer tensor, got {pos.dtype}")
    if any(x.device != q.device for x in (k, v, pos)):
        raise ValueError(f"q lies on {q.device}, k on {k.device}, v on {v.device}, "
                         f"pos on {pos.device}")
    if not q.is_cuda:
        return ref.decode_attention(q, k, v, pos)
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32 on the GPU, got {pos.dtype}")
    if d not in _da.HEAD_DIMS or hq // hkv not in _da.GROUPS:
        raise ValueError(f"the kernel takes D in {_da.HEAD_DIMS} and Hq/Hkv in {_da.GROUPS}, "
                         f"got D={d}, Hq/Hkv={hq // hkv}")
    for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        _require_contiguous(name, x)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if b:
        _da.launch(q, k, v, pos, out)
    return out
