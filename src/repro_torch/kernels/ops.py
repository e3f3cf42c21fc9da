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

from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import interaction as _ix
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)


def launch_counts() -> dict[str, int]:
    """Kernel launches made by this process since the last reset."""
    return {"embedding_bag": _eb.launch_count, "dot_interaction": _ix.launch_count}


def reset_launch_counts() -> None:
    _eb.launch_count = 0
    _ix.launch_count = 0


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
