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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch import flags
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


def checkpointed(fn, *args):
    """``fn(*args)``, under activation checkpointing while grad is enabled
    (autograd keeps the arguments; the backward runs ``fn`` again), else
    plainly.  ``fn`` draws no random numbers, so no RNG state is kept."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _kv_step(qi: torch.Tensor, kj: torch.Tensor, vj: torch.Tensor, m: torch.Tensor,
             l: torch.Tensor, acc: torch.Tensor, q0: int, k0: int, causal: bool):
    """One KV chunk of ``flash_sdpa``'s online softmax: qi (b, h, g, qc, d)
    at query rows q0.., kj/vj (b, h, kc, d) at key rows k0..; the carry
    (m, l, acc) in, the carry out."""
    qc, kc = qi.shape[-2], kj.shape[-2]
    sij = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj).float() * (1.0 / qi.shape[-1] ** 0.5)
    if causal:
        valid = (q0 + torch.arange(qc, device=qi.device))[:, None] >= \
            (k0 + torch.arange(kc, device=qi.device))[None, :]
        sij = torch.where(valid, sij, torch.full_like(sij, NEG_INF))
    m_new = torch.maximum(m, sij.amax(-1))
    p = torch.exp(sij - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bhkd->bhgqd", p.to(vj.dtype), vj).float()
    return m_new, l, acc


def _q_chunk(qi: torch.Tensor, kr: torch.Tensor, vr: torch.Tensor, q0: int,
             causal: bool) -> torch.Tensor:
    """``flash_sdpa``'s whole KV loop for one query chunk qi (b, h, g, qc,
    d) at rows q0.. against kr/vr (nk, b, h, kc, d): its output, in qi's
    dtype; each KV step ``checkpointed``."""
    b, hkv, g, qc, d = qi.shape
    kc = kr.shape[-2]
    m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32, device=qi.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32, device=qi.device)
    for jk in range(kr.shape[0]):
        m, l, acc = checkpointed(_kv_step, qi, kr[jk], vr[jk], m, l, acc, q0, jk * kc, causal)
    return (acc / l.clamp_min(1e-30)[..., None]).to(qi.dtype)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
               q_chunk: int = 256, kv_chunk: int = 512) -> torch.Tensor:
    """Chunked attention with an online softmax: peak score memory is
    (B, Hkv, G, q_chunk, kv_chunk) instead of (…, S, T).  q (B, S, Hq, D),
    k/v (B, T, Hkv, D) → (B, S, Hq, D).  Scores, running max and sum are
    float32; each chunk's probabilities are cast to v's dtype for the
    product with v, as the JAX package's ``flash_sdpa`` does.  Under
    ``flags.unrolled_scans()`` (the accounting tools) the chunks are
    ``flags.ACCOUNTING_FLASH_CHUNKS``.

    With grad enabled, both loop bodies are checkpointed, as the
    reference's ``jax.checkpoint`` of ``q_body`` and ``kv_body``: autograd
    keeps q, k and v (each chunk a view of them) and no chunk's scores; the
    backward runs a query chunk's KV loop again, keeping each step's carry
    (m, l, acc), then each step again for its gradient, so each chunk
    pair's scores are computed three times (four in a checkpointed layer).
    The bits are those of the loop without checkpoints."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk, kv_chunk = flags.flash_chunks(q_chunk, kv_chunk)
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    if s % qc or t % kc:
        raise ValueError(f"S={s} and T={t} must be multiples of the chunks {qc}, {kc}")
    qr = q.reshape(b, s // qc, qc, hkv, g, d).permute(1, 0, 3, 4, 2, 5)   # (nq, b, h, g, qc, d)
    kr = k.reshape(b, t // kc, kc, hkv, d).permute(1, 0, 3, 2, 4)         # (nk, b, h, kc, d)
    vr = v.reshape(b, t // kc, kc, hkv, d).permute(1, 0, 3, 2, 4)
    outs = [checkpointed(_q_chunk, qr[iq], kr, vr, iq * qc, causal) for iq in range(s // qc)]
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


def _uneven_heads(t: torch.Tensor, n: int) -> bool:
    """A DTensor projection whose last dim (n heads) is split over a mesh
    axis that n does not divide."""
    return isinstance(t, DTensor) and any(
        p.is_shard(t.ndim - 1) and n % t.device_mesh.size(axis)
        for axis, p in enumerate(t.placements))


def _whole_heads(t: torch.Tensor) -> torch.Tensor:
    """t with its last dim gathered on every mesh axis that splits it."""
    return t.redistribute(placements=[Replicate() if p.is_shard(t.ndim - 1) else p
                                      for p in t.placements])


def attention(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
              causal: bool = True, positions: torch.Tensor | None = None,
              freqs: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, d_model) → (B, S, d_model) self-attention; RoPE at
    ``positions`` (default 0..S-1) when ``freqs`` is given.

    On DTensors the core (RoPE, scores, softmax, the product with V) runs on
    each rank's local tensors through ``local_map``: heads and samples never
    meet in it, so a rank's batch shard and its heads, each sequence whole,
    are all it needs.
    Where the query or the KV head count does not divide a mesh axis that
    splits the projections, their outputs are gathered over that axis
    first (as Megatron replicates KV heads): only activations move, the
    weights keep their placements, and the core's output is split again as
    the projections were before it meets the output projection."""
    out, _, _ = attend(params, x, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                       causal=causal, positions=positions, freqs=freqs)
    return linear(params["wo"], out)


def attend(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
           causal: bool = True, positions: torch.Tensor | None = None,
           freqs: torch.Tensor | None = None):
    """``attention`` up to its output projection: (the heads' outputs
    (B, S, Hq·D), split as the projections are; k after RoPE and v,
    (B, S, Hkv, D) each, as the core had them: a prefill's cache rows)."""
    b, s, _ = x.shape
    q, k, v = (linear(params[name], x) for name in ("wq", "wk", "wv"))
    split = None
    if _uneven_heads(q, n_heads) or _uneven_heads(k, n_kv_heads):
        split = q.placements
        q, k, v = (_whole_heads(t) for t in (q, k, v))
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    mask = causal_mask(s, x.device) if causal and s * s <= _FLASH_THRESHOLD else None

    def core(q, k, v):
        if freqs is not None:
            pos = positions if positions is not None else torch.arange(s, device=q.device)
            q, k = apply_rope(q, pos, freqs), apply_rope(k, pos, freqs)
        return _sdpa(q, k, v, mask, causal_hint=causal), k

    if isinstance(q, DTensor):
        # a split of the batch (dim 0) or of the heads (dim 2) stays; the
        # sequence is made whole, since every query reads every key
        pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements)
        core = local_map(core, out_placements=(list(pl), list(pl)),
                         in_placements=(pl, pl, pl), in_grad_placements=(pl, pl, pl),
                         device_mesh=q.device_mesh, redistribute_inputs=True)
    out, k = core(q, k, v)
    out = out.reshape(b, s, n_heads * head_dim)
    if split is not None:
        # split again as the projections were (a local slice): the output
        # projection takes it as it is, and its gradient is gathered before
        # the heads are
        out = out.redistribute(placements=split)
    return out, k, v


# ------------------------------------------------------------------- decode


def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
                  dtype: torch.dtype = torch.float32, device: torch.device | str):
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def write_kv(cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k, v (B, Hkv, D) at each sequence's slot ``pos`` of the cache,
    in place.  A sequence whose ``pos`` is outside the cache keeps its
    cache as it was (the JAX package's out-of-range write is dropped): the
    index is clamped and the old row blended back, with no host sync and no
    device-side assert.

    On DTensor caches each rank writes its local tensors.  A cache split
    over time (``lm_cache_pspecs``) holds slots [r·⌈T/m⌉, …) on rank r of
    the axis: the rank writes at the local slot ``pos − r·⌈T/m⌉`` and keeps
    every row where that slot is not one of its own."""
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    if not isinstance(ck, DTensor):
        _write_rows(ck, cv, k, v, pos)
        return
    mesh = ck.device_mesh
    rows = ops.cache_split(ck.placements, 1)
    _write_rows(ck.to_local(), cv.to_local(), k.redistribute(mesh, rows).to_local(),
                v.redistribute(mesh, rows).to_local(),
                pos.redistribute(mesh, ops.cache_split(ck.placements, None)).to_local(),
                ops.first_slot(ck)[1])


def _write_rows(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor, lo: int = 0) -> None:
    """``write_kv`` on plain tensors whose slot 0 is the cache's slot ``lo``."""
    b, t = ck.shape[:2]
    slot = pos.long() - lo
    bidx = torch.arange(b, device=pos.device)
    keep = ((slot >= 0) & (slot < t))[:, None, None]
    slot = slot.clamp(0, t - 1)
    for c, new in ((ck, k), (cv, v)):
        old = c[bidx, slot]
        c[bidx, slot] = torch.where(keep, new.to(old.dtype), old)


def _rope_at(q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor):
    """q (B, 1, Hq, D) and k (B, 1, Hkv, D) rotated at each sequence's
    ``pos``; on DTensors on each rank's batch shard and heads."""
    def rope(q, k, pos):
        return apply_rope(q, pos[:, None], freqs), apply_rope(k, pos[:, None], freqs)

    if not isinstance(q, DTensor):
        return rope(q, k, pos)
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in q.placements)
    pos_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    return local_map(rope, out_placements=(list(pl), list(pl)),
                     in_placements=(pl, pl, pos_pl), device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, pos)


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
    the kernel, which attends to ``t < n``, is given ``n = pos + 1``.

    On DTensors (a decode cell, ``launch/steps.py``) the projections are
    gathered where their heads do not divide the axis that splits them, as
    in ``attention``; RoPE runs on each rank's shards, the write on each
    rank's slots (``write_kv``) and K4 on each rank's cache
    (``kernels.ops.decode_attention``, which merges a cache split over time)."""
    b = x.shape[0]
    q, k, v = (linear(params[name], x) for name in ("wq", "wk", "wv"))
    split = None
    if _uneven_heads(q, n_heads) or _uneven_heads(k, n_kv_heads):
        split = q.placements
        q, k, v = (_whole_heads(t) for t in (q, k, v))
    q = q.reshape(b, 1, n_heads, head_dim)
    k = k.reshape(b, 1, n_kv_heads, head_dim)
    v = v.reshape(b, 1, n_kv_heads, head_dim)
    pos = cache["pos"]
    if freqs is not None:
        q, k = _rope_at(q, k, pos, freqs)
    write_kv(cache, k[:, 0], v[:, 0])
    out = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], pos + 1)
    out = out.reshape(b, 1, n_heads * head_dim)
    if split is not None:
        out = out.redistribute(placements=split)
    out = linear(params["wo"], out)
    return out, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
