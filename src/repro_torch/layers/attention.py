"""Multi-head / grouped-query attention with RoPE and a decode KV cache.

Used by the LM architectures (qwen2, phi3, yi: all GQA) and, without RoPE
or causality, by BERT4Rec's bidirectional encoder.

Scores of the full-sequence paths are scaled by ``1/√head_dim`` in the
input's dtype, masked with ``-1e9`` (bfloat16-safe) and normalised in
float32, as the JAX package does.  A causal self-attention longer than
``_FLASH_THRESHOLD`` score elements per head takes the chunked
online-softmax path (``flash_sdpa``), plain tensor code.  One-token decode
(``decode_attention``) goes through ``kernels.ops.decode_attention``: the
hand-written kernel K4 on the GPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.layers.mlp import init_linear, linear

NEG_INF = -1e9


def init_attention(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   dtype: torch.dtype = torch.float32, device: torch.device | str):
    """Projections; the q, k and v ones carry a bias with ``qkv_bias``
    (``linear`` applies a ``b`` wherever a tree has one)."""
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": init_linear(generator, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "wk": init_linear(generator, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wv": init_linear(generator, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wo": init_linear(generator, n_heads * head_dim, d_model, bias=False, **kw),
    }


# -------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, *, base: float = 10000.0,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,) → rotated x.

    The rotated pairs are interleaved, ``(x[..., 2i], x[..., 2i+1])``, and
    stacked back in place (not the rotate-half layout).  Angles are
    float32; the result is cast to x's dtype."""
    angles = positions[..., None].float() * freqs                   # (B?, S, D/2)
    if angles.ndim == 2:
        angles = angles[None]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------- full attn


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               q_chunk: int = 256, kv_chunk: int = 512) -> torch.Tensor:
    """Chunked attention with an online softmax: peak score memory is
    (B, Hkv, G, q_chunk, kv_chunk) instead of (…, S, T).  q (B, S, Hq, D),
    k/v (B, T, Hkv, D) → (B, S, Hq, D).  Scores, running max and sum are
    float32; each chunk's probabilities are cast to v's dtype for the
    product with v, as the JAX package's ``flash_sdpa`` does."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    if s % qc or t % kc:
        raise ValueError(f"S={s} and T={t} must be multiples of the chunks {qc}, {kc}")
    scale = 1.0 / d ** 0.5
    qr = q.reshape(b, s // qc, qc, hkv, g, d).permute(1, 0, 3, 4, 2, 5)   # (nq, b, h, g, qc, d)
    kr = k.reshape(b, t // kc, kc, hkv, d).permute(1, 0, 3, 2, 4)         # (nk, b, h, kc, d)
    vr = v.reshape(b, t // kc, kc, hkv, d).permute(1, 0, 3, 2, 4)
    q_off = torch.arange(qc, device=q.device)
    k_off = torch.arange(kc, device=q.device)
    outs = []
    for iq in range(s // qc):
        qi = qr[iq]
        m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32, device=q.device)
        for jk in range(t // kc):
            sij = torch.einsum("bhgqd,bhkd->bhgqk", qi, kr[jk]).float() * scale
            if causal:
                valid = (iq * qc + q_off)[:, None] >= (jk * kc + k_off)[None, :]
                sij = torch.where(valid, sij, torch.full_like(sij, NEG_INF))
            m_new = torch.maximum(m, sij.amax(-1))
            p = torch.exp(sij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype), vr[jk]).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    out = torch.stack(outs)                                               # (nq, b, h, g, qc, d)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, s, hq, d)


# above this many score elements per head, a causal self-attention takes
# the chunked path
_FLASH_THRESHOLD = 2048 * 2048


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None, *,
          causal_hint: bool = False) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D) grouped; mask broadcastable to
    (B, 1, S, T), True where a query may attend → (B, S, Hq, D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if causal_hint and s == k.shape[1] and s * s > _FLASH_THRESHOLD:
        return flash_sdpa(q, k, v, causal=True)
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg, k) / math.sqrt(d)
    if mask is not None:
        m = mask[:, :, None] if mask.ndim == 4 else mask
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hq, d)


def causal_mask(s: int, device: torch.device | str) -> torch.Tensor:
    """(1, 1, S, S), True on and below the diagonal."""
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()[None, None]


def attention(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True, positions: torch.Tensor | None = None,
              freqs: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, d_model) → (B, S, d_model) self-attention; RoPE at
    ``positions`` (default 0..S-1) when ``freqs`` is given."""
    b, s, _ = x.shape
    q = linear(params["wq"], x).reshape(b, s, n_heads, head_dim)
    k = linear(params["wk"], x).reshape(b, s, n_kv_heads, head_dim)
    v = linear(params["wv"], x).reshape(b, s, n_kv_heads, head_dim)
    if freqs is not None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q, k = apply_rope(q, pos, freqs), apply_rope(k, pos, freqs)
    mask = causal_mask(s, x.device) if causal and s * s <= _FLASH_THRESHOLD else None
    out = _sdpa(q, k, v, mask, causal_hint=causal)
    return linear(params["wo"], out.reshape(b, s, n_heads * head_dim))


# ------------------------------------------------------------------- decode


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
                  dtype: torch.dtype = torch.float32, device: torch.device | str):
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def write_kv(cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k, v (B, Hkv, D) at each sequence's slot ``pos`` of the cache,
    in place.  A sequence whose ``pos`` is past the cache keeps its cache
    as it was (the JAX package's out-of-range write is dropped): the index
    is clamped and the old row blended back, with no host sync and no
    device-side assert."""
    b, t = cache["k"].shape[:2]
    pos = cache["pos"]
    bidx = torch.arange(b, device=pos.device)
    slot = pos.clamp(0, t - 1).long()
    keep = (pos < t)[:, None, None]
    for name, new in (("k", k), ("v", v)):
        old = cache[name][bidx, slot]
        cache[name][bidx, slot] = torch.where(keep, new.to(old.dtype), old)


def decode_attention(params, x: torch.Tensor, cache: dict, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, freqs: torch.Tensor | None = None):
    """One-token decode.  x (B, 1, d_model); cache holds k, v (B, T, Hkv, D)
    and pos (B,) int32.  Returns (output (B, 1, d_model), cache).

    The new K/V are written **in place** into the cache's preallocated
    tensors (a functional copy would move the whole cache every step:
    2.15 GB a layer for qwen2-0.5b at decode_32k); the returned cache holds
    the same k and v tensors and ``pos + 1``.  A cache passed in is
    therefore changed: keep a copy if the old state is needed.

    The query attends to slots ``t <= pos`` (the new token included), so
    the kernel, which attends to ``t < n``, is given ``n = pos + 1``."""
    b = x.shape[0]
    q = linear(params["wq"], x).reshape(b, 1, n_heads, head_dim)
    k = linear(params["wk"], x).reshape(b, 1, n_kv_heads, head_dim)
    v = linear(params["wv"], x).reshape(b, 1, n_kv_heads, head_dim)
    pos = cache["pos"]
    if freqs is not None:
        q = apply_rope(q, pos[:, None], freqs)
        k = apply_rope(k, pos[:, None], freqs)
    write_kv(cache, k[:, 0], v[:, 0])
    out = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], pos + 1)
    out = linear(params["wo"], out.reshape(b, 1, n_heads * head_dim))
    return out, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
