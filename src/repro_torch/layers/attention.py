"""Multi-head / grouped-query attention, the part that BERT4Rec's
bidirectional encoder uses: projections, an optional causal mask and the
plain softmax path.

Scores are scaled by ``1/√head_dim`` in the input's dtype, masked with
``-1e9`` (bfloat16-safe) and normalised in float32.  RoPE, the chunked
flash path and the decode KV cache arrive with the LM slice; until then a
causal call of any length builds the full ``(S, S)`` mask, which computes
the same function as the chunked path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.layers.mlp import init_linear, linear

NEG_INF = -1e9


def init_attention(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, dtype: torch.dtype = torch.float32,
                   device: torch.device | str):
    """Projections without biases (``linear`` applies a ``b`` where a
    converted tree has one)."""
    kw = dict(bias=False, dtype=dtype, device=device)
    return {
        "wq": init_linear(generator, d_model, n_heads * head_dim, **kw),
        "wk": init_linear(generator, d_model, n_kv_heads * head_dim, **kw),
        "wv": init_linear(generator, d_model, n_kv_heads * head_dim, **kw),
        "wo": init_linear(generator, n_heads * head_dim, d_model, **kw),
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) grouped; mask broadcastable to
    (B, 1, S, T), True where a query may attend → (B, S, Hq, D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k) / math.sqrt(d)
    if mask is not None:
        m = mask[:, :, None] if mask.ndim == 4 else mask
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


def attention(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True) -> torch.Tensor:
    """x (B, S, d_model) → (B, S, d_model) self-attention."""
    b, s, _ = x.shape
    q = linear(params["wq"], x).reshape(b, s, n_heads, head_dim)
    k = linear(params["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = linear(params["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    mask = None
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()[None, None]
    out = _sdpa(q, k, v, mask)
    return linear(params["wo"], out.reshape(b, s, n_heads * head_dim))
