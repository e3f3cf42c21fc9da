"""Plain PyTorch versions of every hand-written kernel.

They are the ground truth the kernels are held against on the card, and
what the public wrappers in ``ops`` run for a tensor that lies on the CPU.
Nothing on the serving path calls them for a CUDA tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None, *,
                  mode: str = "sum") -> torch.Tensor:
    """table (V, D), idx (B, H) → (B, D), pooled in float32 and cast back
    to the table's dtype (what the kernel does)."""
    rows = table[idx.long()].float()                       # (B, H, D)
    if weights is not None:
        rows = rows * weights[..., None].float()
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / idx.shape[1]
    elif mode != "sum":
        raise ValueError(f"unknown pooling mode {mode!r}")
    return out.to(table.dtype)


def embedding_bag_stacked(tables: torch.Tensor, idx: torch.Tensor, *,
                          mode: str = "sum") -> torch.Tensor:
    """tables (F, V, D), idx (B, F, H) → (B, F, D): field ``f`` of every
    sample looks up table ``f``."""
    f = tables.shape[0]
    field = torch.arange(f, device=tables.device)[None, :, None]
    rows = tables[field, idx.long()].float()               # (B, F, H, D)
    out = rows.sum(dim=2)
    if mode == "mean":
        out = out / idx.shape[2]
    elif mode != "sum":
        raise ValueError(f"unknown pooling mode {mode!r}")
    return out.to(tables.dtype)


def tril_pairs(f: int) -> np.ndarray:
    """Flat indices of the strict lower triangle of an f×f matrix, in
    ``np.tril_indices(f, -1)`` row-major order."""
    li, lj = np.tril_indices(f, k=-1)
    return (li * f + lj).astype(np.int64)


def gram(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F·F) flattened Gram matrices, float32
    accumulation, stored in the input's dtype."""
    b, f, _ = feats.shape
    x = feats.float()
    return torch.einsum("bfd,bgd->bfg", x, x).reshape(b, f * f).to(feats.dtype)


def dot_interaction_packed(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F(F-1)/2) packed pairwise dots."""
    f = feats.shape[1]
    li, lj = torch.tril_indices(f, f, offset=-1, device=feats.device)
    return gram(feats)[:, li * f + lj]
