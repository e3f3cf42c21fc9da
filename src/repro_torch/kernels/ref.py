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


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor, vocab: int, *,
                           mode: str = "sum") -> torch.Tensor:
    """The gradient of ``embedding_bag_stacked`` with respect to its tables:
    grad_out (B, F, D), idx (B, F, H) → (F, V, D), every (b, f, h) adding
    ``grad_out[b, f]`` (divided by H for ``mean``) into row ``idx[b, f, h]``
    of table f, by ``index_add_``.  A dense table-shaped result, as the
    reference's autodiff gives; float32 (float64 for a float64 grad_out, the
    exact value the card's checks use), whatever the tables' dtype."""
    b, f, h = idx.shape
    d = grad_out.shape[-1]
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    g = grad_out.to(acc)
    if mode == "mean":
        g = g / h
    elif mode != "sum":
        raise ValueError(f"unknown pooling mode {mode!r}")
    rows = (idx.long() + torch.arange(f, device=idx.device)[None, :, None] * vocab).reshape(-1)
    vals = g[:, :, None, :].expand(b, f, h, d).reshape(-1, d)
    out = torch.zeros((f * vocab, d), dtype=acc, device=grad_out.device)
    return out.index_add_(0, rows, vals).view(f, vocab, d)


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


def dot_interaction_backward(grad: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """The gradient of ``dot_interaction_packed`` with respect to its input:
    grad (B, F(F-1)/2), feats (B, F, D) → (B, F, D) = (S + Sᵀ)·X, S the
    strict lower triangle scattered from ``tril_pairs(F)``.  float32
    (float64 for float64 inputs), stored in the features' dtype."""
    b, f, _ = feats.shape
    acc = torch.promote_types(feats.dtype, torch.float32)
    li, lj = torch.tril_indices(f, f, offset=-1, device=feats.device)
    s = torch.zeros((b, f, f), dtype=acc, device=feats.device)
    s[:, li, lj] = grad.to(acc)
    return torch.bmm(s + s.transpose(1, 2), feats.to(acc)).to(feats.dtype)


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


def cin_layer_backward(g: torch.Tensor, x0: torch.Tensor, xk: torch.Tensor,
                       w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``cin_layer``: g = ∂L/∂out (B, Hn, D) → (dx0, dxk,
    dw).  With ``P[b, h·F+f, d] = Σ_n w[h·F+f, n] · g[b, n, d]``:
    ``dxk[b,h,d] = Σ_f P·x0[b,f,d]``, ``dx0[b,f,d] = Σ_h P·xk[b,h,d]`` and
    ``dw[h·F+f, n] = Σ_{b,d} xk[b,h,d] · x0[b,f,d] · g[b,n,d]``.

    P and the outer-product maps ``(B, H·F, D)`` are materialised.  Float32
    (float64 for a float64 input); each result is stored in its input's
    dtype."""
    b, f, d = x0.shape
    h, n = xk.shape[1], w.shape[1]
    acc = torch.promote_types(x0.dtype, torch.float32)
    g_, x0_, xk_ = g.to(acc), x0.to(acc), xk.to(acc)
    p = torch.einsum("mn,bnd->bmd", w.to(acc), g_).reshape(b, h, f, d)
    dxk = torch.einsum("bhfd,bfd->bhd", p, x0_)
    dx0 = torch.einsum("bhfd,bhd->bfd", p, xk_)
    inter = torch.einsum("bhd,bfd->bhfd", xk_, x0_).reshape(b, h * f, d)
    dw = torch.einsum("bmd,bnd->mn", inter, g_)
    return dx0.to(x0.dtype), dxk.to(xk.dtype), dw.to(w.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, return_lse: bool = False):
    """Grouped decode attention against a position-masked KV cache.

    q (B, Hq, D); k, v (B, T, Hkv, D); pos (B,) valid length per sequence
    → (B, Hq, D).  Query head ``h·G + g`` reads KV head ``h``.  Slots
    ``t >= pos[b]`` score -1e30, so ``pos <= 0`` masks every slot and the
    softmax is uniform: the result is then the mean of V over all T.
    float32 throughout (what the kernel does); the result is cast to q's
    dtype.  With ``return_lse`` also each query head's log-sum-exp of its
    scaled scores over the valid slots, (B, Hq) float32: ``-inf`` where
    ``pos <= 0`` (no valid slot), so that such a slice weighs nothing in
    ``merge_decode_attention``."""
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k.float()) / math.sqrt(d)
    mask = (torch.arange(t, device=q.device)[None] < pos[:, None])[:, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", probs, v.float()).reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1).reshape(b, hq)
    return out, torch.where((pos > 0)[:, None], lse, torch.full_like(lse, -math.inf))


def merge_decode_attention(outs: torch.Tensor, lses: torch.Tensor):
    """The decode attention of a cache cut over time into slices, from each
    slice's result: ``outs`` (R, B, Hq, D) and ``lses`` (R, B, Hq), slice r
    holding slots [r·T_r, (r+1)·T_r) at its own valid length.  With
    ``m = max_r lse_r``: ``out = Σ_r e^{lse_r − m}·out_r / Σ_r e^{lse_r − m}``
    and ``lse = m + log Σ_r e^{lse_r − m}``, each sum taken over r in order,
    float32 inside; ``out`` in the outs' dtype.
    Where no slice has a valid slot (every lse ``-inf``) the slices weigh
    alike: the mean of equal slices' means, the mean of V, as one call
    over the whole cache gives; lse stays ``-inf``."""
    lses = lses.float()
    m = lses.amax(dim=0)
    empty = torch.isinf(m) & (m < 0)
    num = den = None
    for r in range(outs.shape[0]):
        w = torch.where(empty, torch.ones_like(m), torch.exp(lses[r] - m))
        term = w[..., None] * outs[r].float()
        num = term if num is None else num + term
        den = w if den is None else den + w
    lse = torch.where(empty, m, m + torch.log(den))
    return (num / den[..., None]).to(outs.dtype), lse
