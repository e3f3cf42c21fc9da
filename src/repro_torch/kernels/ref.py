"""Plain PyTorch versions of every hand-written kernel.

They are the ground truth the kernels are held against on the card, and
what the public wrappers in ``ops`` run for a tensor that lies on the CPU.
Nothing on the serving path calls them for a CUDA tensor.
"""
from __future__ import annotations

import math

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


def cin_layer(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One xDeepFM CIN layer: x0 (B, F, D), xk (B, H, D), w (H·F, Hn) →
    (B, Hn, D), ``out[b, n, d] = Σ_{h,f} w[h·F+f, n] · xk[b,h,d] · x0[b,f,d]``.

    The outer-product maps ``(B, H·F, D)`` are materialised, then
    contracted with ``w``.  Products and sums are float32 (float64 for a
    float64 input, which the card's checks use as the exact value); the
    result is stored in ``x0``'s dtype."""
    b, f, d = x0.shape
    h = xk.shape[1]
    acc = torch.promote_types(x0.dtype, torch.float32)
    inter = torch.einsum("bhd,bfd->bhfd", xk.to(acc), x0.to(acc)).reshape(b, h * f, d)
    return torch.einsum("bmd,mn->bnd", inter, w.to(acc)).to(x0.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Grouped decode attention against a position-masked KV cache.

    q (B, Hq, D); k, v (B, T, Hkv, D); pos (B,) valid length per sequence
    → (B, Hq, D).  Query head ``h·G + g`` reads KV head ``h``.  Slots
    ``t >= pos[b]`` score -1e30, so ``pos <= 0`` masks every slot and the
    softmax is uniform: the result is then the mean of V over all T.
    float32 throughout (what the kernel does); the result is cast to q's
    dtype."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) / math.sqrt(d)
    mask = (torch.arange(t, device=q.device)[None] < pos[:, None])[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
