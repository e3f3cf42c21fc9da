"""Embedding tables and the fixed-hotness embedding bag.

Every bag has exactly ``H`` lookups: indices ``(..., H)``, the layout of
the DLRM-RMC*/DIN synthetic workloads.  Unweighted ``sum`` and ``mean``
pooling go through ``kernels.ops.embedding_bag`` (the hand-written kernel
on the GPU); weighted pooling, ``max`` and ``none`` are plain tensor code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def init_table(generator: torch.Generator, vocab: int, dim: int, *,
               dtype: torch.dtype = torch.float32, scale: float | None = None,
               device: torch.device | str) -> torch.Tensor:
    """``(vocab, dim)`` normal table, made on ``device`` (the generator must
    live there too), scaled in place."""
    scale = scale if scale is not None else 1.0 / dim ** 0.5
    t = torch.randn((vocab, dim), generator=generator, device=device, dtype=dtype)
    return t.mul_(scale)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup.  ``table (V, D)``, ``idx (..., H)`` → ``(..., D)``.

    ``weights`` (same shape as idx) gives weighted pooling; ``mode='none'``
    returns the unpooled ``(..., H, D)`` rows.
    """
    if mode not in ("sum", "mean", "max", "none"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    if weights is None and mode in ("sum", "mean"):
        lead = idx.shape[:-1]
        flat = idx.reshape(-1, idx.shape[-1]).contiguous()
        return ops.embedding_bag(table, flat, mode=mode).reshape(*lead, table.shape[1])
    rows = table[idx.long()]                       # (..., H, D)
    if weights is not None:
        rows = rows * weights[..., None]
    if mode == "sum":
        return rows.sum(dim=-2)
    if mode == "mean":
        return rows.mean(dim=-2)
    if mode == "max":
        return rows.max(dim=-2).values
    return rows
