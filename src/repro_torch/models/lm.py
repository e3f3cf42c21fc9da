"""Decoder-only transformer LM: the dense configs (qwen2, phi3, yi) and the
mixture-of-experts ones (granite-moe, qwen3-moe, top-8), GQA + RoPE +
RMSNorm + SwiGLU (a SwiGLU expert stack, ``layers.moe``, in the MoE ones).

Entry points:
    forward(params, cfg, tokens)                  logits of a full sequence
    loss_fn(params, cfg, batch)                   next-token cross-entropy
    prefill(params, cfg, tokens, max_len)         last-token logits and KV caches
    decode_step(params, cfg, token, caches)       one token against the caches

Parameters are a plain dictionary with the JAX package's keys and layouts;
``layers`` is a Python list of per-layer dictionaries (``compat`` unstacks
a JAX tree whose layers are stacked).  Every decode step sends each layer's
attention through ``kernels.ops.decode_attention``: on the GPU the
hand-written kernel K4, once per layer per step.  The caches are updated in
place (see ``layers.attention.decode_attention``).

An MoE layer routes the tokens of each call with the reference's
capacity, so for an MoE config prefill then decode is not a forward of
the whole sequence (``layers.moe``).  Training runs no hand-written
kernel: ``forward_hidden``'s attention is plain tensor code.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers.mlp import ffn_swiglu, init_ffn_swiglu, init_linear, linear
from repro_torch.layers.norms import init_rms_norm, rms_norm


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_base: float = 10000.0
    n_experts: int = 0                   # MoE (0 → dense)
    top_k: int = 0
    tie_embeddings: bool = False
    dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.is_moe:
            ffn = 3 * d * self.d_ff * self.n_experts + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * d) + emb + d

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only the top-k experts)."""
        if not self.is_moe:
            return self.param_count
        inactive = 3 * self.d_model * self.d_ff * (self.n_experts - self.top_k)
        return self.param_count - self.n_layers * inactive


def init(generator: torch.Generator, cfg: LMConfig, *,
         device: torch.device | str | None = None):
    """Random parameters on ``device`` (the GPU unless the caller passes
    one); ``generator`` must live on the same device."""
    device = resolve(device)
    dt = cfg.tdtype
    kw = dict(dtype=dt, device=device)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator, device=device)
    p: dict = {"embed": embed.mul_(0.02).to(dt), "ln_f": init_rms_norm(cfg.d_model, **kw),
               "layers": []}
    if not cfg.tie_embeddings:
        p["unembed"] = init_linear(generator, cfg.d_model, cfg.vocab, bias=False, **kw)
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": init_rms_norm(cfg.d_model, **kw),
            "attn": attn_lib.init_attention(generator, cfg.d_model, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.hd, qkv_bias=cfg.qkv_bias,
                                            **kw),
            "ln2": init_rms_norm(cfg.d_model, **kw),
        }
        if cfg.is_moe:
            layer["moe"] = moe_lib.init_moe(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                            cfg.top_k, **kw)
        else:
            layer["ffn"] = init_ffn_swiglu(generator, cfg.d_model, cfg.d_ff, **kw)
        p["layers"].append(layer)
    return p


def _freqs(cfg: LMConfig, device) -> torch.Tensor:
    return attn_lib.rope_freqs(cfg.hd, base=cfg.rope_base, device=device)


def _unembed(params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return linear(params["unembed"], x)


def _ffn(layer, cfg: LMConfig, x: torch.Tensor):
    """The layer's feed-forward block on x (B, S, d): (output, MoE aux loss
    or None for a dense layer)."""
    if cfg.is_moe:
        y, aux = moe_lib.apply_moe(layer["moe"], x, top_k=cfg.top_k)
        return y, aux["aux_loss"]
    return ffn_swiglu(layer["ffn"], x), None


def forward_hidden(params, cfg: LMConfig, tokens: torch.Tensor):
    """tokens (B, S) int → (final hidden state (B, S, d_model), the sum of
    the MoE layers' auxiliary losses, a float32 scalar: 0 for a dense
    config)."""
    x = params["embed"][tokens.long()]
    freqs = _freqs(cfg, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        x = x + attn_lib.attention(layer["attn"], rms_norm(layer["ln1"], x),
                                   n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                   head_dim=cfg.hd, causal=True, freqs=freqs)
        f, aux = _ffn(layer, cfg, rms_norm(layer["ln2"], x))
        x = x + f
        if aux is not None:
            aux_total = aux_total + aux
    return rms_norm(params["ln_f"], x), aux_total


def forward(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S, V) (the reference's ``forward``
    also returns the MoE auxiliary loss sum: ``forward_hidden`` has it)."""
    return _unembed(params, cfg, forward_hidden(params, cfg, tokens)[0])


_LOSS_CHUNK = 512       # sequence chunk of the cross-entropy (big-vocab memory)


def _chunk_nll(params, cfg: LMConfig, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of hidden states x (B, S', d) against labels (B, S')."""
    logp = torch.log_softmax(_unembed(params, cfg, x).float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].sum()


def loss_fn(params, cfg: LMConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S), logits in float32, plus 0.01 times the MoE
    layers' auxiliary loss sum (0 for a dense config).  When S is a
    multiple of ``_LOSS_CHUNK`` and longer than it, the unembedding and
    log-softmax run one chunk of the sequence at a time, each under
    activation checkpointing (the reference's ``jax.checkpoint``): peak
    logits memory is (B, chunk, V), and the backward recomputes each
    chunk's logits."""
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux = forward_hidden(params, cfg, tokens)
    b, s, _ = x.shape
    if s % _LOSS_CHUNK != 0 or s <= _LOSS_CHUNK:
        return _chunk_nll(params, cfg, x, labels) / (b * s) + 0.01 * aux
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, s, _LOSS_CHUNK):
        total = total + checkpoint(_chunk_nll, params, cfg, x[:, i:i + _LOSS_CHUNK],
                                   labels[:, i:i + _LOSS_CHUNK], use_reentrant=False)
    return total / (b * s) + 0.01 * aux


# ---------------------------------------------------------------- serving


def init_caches(cfg: LMConfig, batch: int, max_len: int, *,
                device: torch.device | str | None = None) -> list[dict]:
    """One zeroed KV cache of ``max_len`` slots per layer, ``pos`` 0."""
    device = resolve(device)
    return [attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype=cfg.tdtype,
                                   device=device)
            for _ in range(cfg.n_layers)]


def _prefill_layer(layer, cfg: LMConfig, x: torch.Tensor, freqs: torch.Tensor, cache: dict):
    """One prefill layer: writes its K/V into ``cache[:, :S]``, returns x."""
    b, s, _ = x.shape
    xin = rms_norm(layer["ln1"], x)
    q = linear(layer["attn"]["wq"], xin).reshape(b, s, cfg.n_heads, cfg.hd)
    k = linear(layer["attn"]["wk"], xin).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = linear(layer["attn"]["wv"], xin).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    pos = torch.arange(s, device=x.device)
    q, k = attn_lib.apply_rope(q, pos, freqs), attn_lib.apply_rope(k, pos, freqs)
    mask = attn_lib.causal_mask(s, x.device) if s * s <= attn_lib._FLASH_THRESHOLD else None
    o = attn_lib._sdpa(q, k, v, mask, causal_hint=True)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    x = x + linear(layer["attn"]["wo"], o.reshape(b, s, cfg.n_heads * cfg.hd))
    return x + _ffn(layer, cfg, rms_norm(layer["ln2"], x))[0]


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int):
    """Run the prompt tokens (B, S), fill fresh KV caches of ``max_len``
    slots; returns (last-token logits (B, V), caches with pos = S)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit caches of {max_len} slots")
    x = params["embed"][tokens.long()]
    freqs = _freqs(cfg, x.device)
    caches = init_caches(cfg, b, max_len, device=x.device)
    for layer, cache in zip(params["layers"], caches):
        x = _prefill_layer(layer, cfg, x, freqs, cache)
        cache["pos"].fill_(s)
    x = rms_norm(params["ln_f"], x[:, -1:])
    return _unembed(params, cfg, x)[:, 0], caches


def decode_step(params, cfg: LMConfig, token: torch.Tensor, caches: list[dict]):
    """token (B,) int → (logits (B, V), caches).  One decode step; each
    layer's new K/V are written in place into ``caches`` (the list
    returned holds the same tensors, with ``pos`` advanced by one)."""
    x = params["embed"][token.long()][:, None]                       # (B, 1, D)
    freqs = _freqs(cfg, x.device)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h, cache = attn_lib.decode_attention(
            layer["attn"], rms_norm(layer["ln1"], x), cache, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, freqs=freqs)
        x = x + h
        x = x + _ffn(layer, cfg, rms_norm(layer["ln2"], x))[0]
        new_caches.append(cache)
    x = rms_norm(params["ln_f"], x)
    return _unembed(params, cfg, x)[:, 0], new_caches
