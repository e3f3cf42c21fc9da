"""Embedding tables and embedding bags.

Two layouts:

* fixed-hotness: every bag has exactly ``H`` lookups, indices ``(..., H)``,
  the layout of the DLRM-RMC*/DIN synthetic workloads.  Unweighted ``sum``
  and ``mean`` pooling go through ``kernels.ops.embedding_bag`` (the
  hand-written kernel on the GPU); weighted pooling, ``max`` and ``none``
  are plain tensor code;
* ragged: flat ``indices (N,)`` + ``offsets (B+1,)`` (the
  ``torch.nn.EmbeddingBag`` layout), pooled with ``index_add_`` /
  ``scatter_reduce``: plain tensor code, no model of the zoo uses it.

Plus the compressed-table lookups (hashing, quotient-remainder).
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


# ---------------------------------------------------------------------- ragged


def segment_ids_from_offsets(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """offsets (B+1,) → the bag of every element, (total,)."""
    pos = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets, pos, right=True) - 1


def embedding_bag_ragged(table: torch.Tensor, indices: torch.Tensor, offsets: torch.Tensor,
                         *, num_bags: int, mode: str = "sum") -> torch.Tensor:
    """Flat ``indices (N,)``, ``offsets (B+1,)`` → ``(num_bags, D)``.  An
    element whose bag falls outside ``[0, num_bags)`` is dropped, and an
    empty bag pools to 0 (``sum``, ``mean``) or ``-inf`` (``max``), as
    ``jax.ops.segment_*`` do."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"unknown pooling mode {mode!r}")
    rows = table[indices.long()]                                     # (N, D)
    seg = segment_ids_from_offsets(offsets, indices.shape[0]).long()
    keep = (seg >= 0) & (seg < num_bags)
    rows, seg = rows[keep], seg[keep]
    shape = (num_bags, table.shape[1])
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=table.dtype, device=table.device)
        return out.scatter_reduce(0, seg[:, None].expand_as(rows), rows, "amax")
    out = torch.zeros(shape, dtype=table.dtype, device=table.device).index_add_(0, seg, rows)
    if mode == "mean":
        cnt = torch.zeros(num_bags, dtype=table.dtype, device=table.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=table.dtype))
        out = out / cnt.clamp(min=1.0)[:, None]
    return out


# ----------------------------------------------------------- compressed tables


def hashed_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Hash trick: fold arbitrary ids into the table's vocab."""
    return table[idx.long() % table.shape[0]]


def init_qr_tables(generator: torch.Generator, vocab: int, dim: int, *, num_buckets: int,
                   dtype: torch.dtype = torch.float32, device: torch.device | str):
    """Quotient-remainder compositional embedding [arXiv:1909.02107]."""
    n_q = -(-vocab // num_buckets)  # ceil
    return {
        "q": init_table(generator, n_q, dim, dtype=dtype, device=device),
        "r": init_table(generator, num_buckets, dim, dtype=dtype, device=device),
        "num_buckets": num_buckets,
    }


def qr_lookup(params, idx: torch.Tensor, *, combine: str = "mult") -> torch.Tensor:
    nb = int(params["num_buckets"])
    i = idx.long()
    q = params["q"][torch.div(i, nb, rounding_mode="floor")]
    r = params["r"][i % nb]
    return q * r if combine == "mult" else q + r
