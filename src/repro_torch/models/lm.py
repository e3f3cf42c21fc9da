"""Decoder-only transformer LM: the dense configs (qwen2, phi3, yi) and the
mixture-of-experts ones (granite-moe, qwen3-moe, top-8), GQA + RoPE +
RMSNorm + SwiGLU (a SwiGLU expert stack, ``layers.moe``, in the MoE ones).

Entry points:
    forward(params, cfg, tokens, moe_fn=None)     logits of a full sequence
    loss_fn(params, cfg, batch, moe_fn=None)      next-token cross-entropy
    prefill(params, cfg, tokens, max_len, moe_fn=None)     last-token logits and KV caches
    decode_step(params, cfg, token, caches, moe_fn=None)   one token against the caches

Parameters are a plain dictionary with the JAX package's keys and layouts;
``layers`` is a Python list of per-layer dictionaries (``compat`` unstacks
a JAX tree whose layers are stacked).  Every decode step sends each layer's
attention through ``kernels.ops.decode_attention``: on the GPU the
hand-written kernel K4, once per layer per step.  The caches are updated in
place (see ``layers.attention.decode_attention``).

An MoE layer routes the tokens of each call with the reference's
capacity, so for an MoE config prefill then decode is not a forward of
the whole sequence (``layers.moe``).  ``moe_fn`` replaces the MoE layers'
``apply_moe`` in a forward, a loss, a prefill or a decode step (the
reference's hook): ``launch/steps.py``'s cells pass ``make_sharded_moe``'s
expert-parallel layer.  Training runs no hand-written
kernel: ``forward_hidden``'s attention is plain tensor code.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import sharding as shd
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embedding as emb_lib
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
    remat: bool = False                  # activation checkpoint per layer

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
    return _logits(x, _unembedding(params, cfg), cfg.tie_embeddings)


def _unembedding(params, cfg: LMConfig) -> torch.Tensor:
    """The tied embedding (V, d) or the unembedding's weight (d, V)."""
    return params["embed"] if cfg.tie_embeddings else params["unembed"]["w"]


def _logits(x: torch.Tensor, w: torch.Tensor, tied: bool) -> torch.Tensor:
    return x @ w.T if tied else x @ w


def _ffn(layer, cfg: LMConfig, x: torch.Tensor, moe_fn=None):
    """The layer's feed-forward block on x (B, S, d): (output, MoE aux loss
    or None for a dense layer).  An MoE layer runs ``moe_fn(layer["moe"],
    x) → (y, {"aux_loss", ...})`` when one is given (the expert-parallel
    ``layers.moe.make_sharded_moe``), else ``apply_moe``."""
    if cfg.is_moe:
        if moe_fn is None:
            y, aux = moe_lib.apply_moe(layer["moe"], x, top_k=cfg.top_k)
        else:
            y, aux = moe_fn(layer["moe"], x)
        return y, aux["aux_loss"]
    return ffn_swiglu(layer["ffn"], x), None


def _layer_fwd(layer, cfg: LMConfig, x: torch.Tensor, freqs: torch.Tensor, moe_fn=None):
    """One layer on x (B, S, d): (x after it, its MoE aux loss or None)."""
    x = x + _residual(x, attn_lib.attention(layer["attn"], rms_norm(layer["ln1"], x),
                                            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                            head_dim=cfg.hd, causal=True, freqs=freqs))
    f, aux = _ffn(layer, cfg, rms_norm(layer["ln2"], x), moe_fn)
    return x + _residual(x, f), aux


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output y at the residual stream x's placements: on
    DTensors the rows split over the batch axes, whole over ``model`` (a
    row-parallel product's partial sum over ``model`` is added up here,
    Megatron's all-reduce).  Left to DTensor's rules the stream stays a
    partial sum, the norm keeps it one, and the next product's rule
    reduce-scatters the activations and gathers the weights whole, by
    batch or by sequence as the local batch divides the axis (a sequence
    split ends in a ``_StridedShard`` whose redistribution reads a value)."""
    if isinstance(y, DTensor) and y.placements != x.placements:
        return shd.redistribute_in_order(y, x.placements)
    return y


def forward_hidden(params, cfg: LMConfig, tokens: torch.Tensor, *, moe_fn=None):
    """tokens (B, S) int → (final hidden state (B, S, d_model), the sum of
    the MoE layers' auxiliary losses, a float32 scalar: 0 for a dense
    config).  ``moe_fn`` replaces ``apply_moe`` in the MoE layers (see
    ``_ffn``).  The token lookup is ``layers.embedding.lookup``: ``jnp.take``'s
    values, and a vocabulary split over a mesh axis is added up.

    With ``cfg.remat`` and grad enabled, each layer runs under activation
    checkpointing (the reference's ``jax.checkpoint`` of ``_layer_fwd``):
    autograd keeps the layer's input only, and the backward runs the layer
    again, its collectives included, before it takes the layer's gradient
    (``layers.attention.checkpointed``).  Under ``no_grad`` or
    ``inference_mode`` nothing is checkpointed."""
    x = emb_lib.lookup(params["embed"], tokens)
    freqs = _freqs(cfg, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if cfg.remat:
            x, aux = attn_lib.checkpointed(_layer_fwd, layer, cfg, x, freqs, moe_fn)
        else:
            x, aux = _layer_fwd(layer, cfg, x, freqs, moe_fn)
        if aux is not None:
            aux_total = aux_total + aux
    return rms_norm(params["ln_f"], x), aux_total


def forward(params, cfg: LMConfig, tokens: torch.Tensor, *, moe_fn=None) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S, V) (the reference's ``forward``
    also returns the MoE auxiliary loss sum: ``forward_hidden`` has it)."""
    return _unembed(params, cfg, forward_hidden(params, cfg, tokens, moe_fn=moe_fn)[0])


_LOSS_CHUNK = 512       # sequence chunk of the cross-entropy (big-vocab memory)


class _VocabNLL(torch.autograd.Function):
    """Summed next-token NLL of logits (B, S', V_r) over one vocabulary
    shard, the rank's ids ``v0 .. v0 + V_r``, against labels (B, S'), in
    float32.  A row whose label lies in the shard picks it (``gather``),
    any other picks 0.  With ``group`` (a ``(mesh, axis)`` the vocabulary
    is split over) the ranks' log-sum-exps and picks are gathered over the
    axis and combined in rank order.  Its backward needs no collective:
    each rank's logits' gradient is ``softmax − one-hot`` on its own shard,
    made in one float32 tensor, the same bits as autograd of
    ``logsumexp(z) − z[label]``."""

    @staticmethod
    def forward(ctx, logits, labels, v0: int, group):
        z = logits.float()
        lse = torch.logsumexp(z, dim=-1)
        idx = labels.long() - v0
        mine = (idx >= 0) & (idx < z.shape[-1])
        idx = idx.clamp(0, z.shape[-1] - 1)
        picked = torch.where(mine, z.gather(-1, idx[..., None])[..., 0], 0.0)
        if group is not None:
            both = _gathered(torch.stack([lse, picked]), group).reshape(-1, 2, *lse.shape)
            lse, picked = torch.logsumexp(both[:, 0], dim=0), both[:, 1].sum(0)
        ctx.save_for_backward(logits, lse, idx, mine)
        return (lse - picked).sum()

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mine = ctx.saved_tensors
        grad = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_().mul_(g)
        grad.scatter_add_(-1, idx[..., None], torch.where(mine, -g, 0.0)[..., None])
        return grad.to(logits.dtype), None, None, None


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    """t of every rank of ``group``'s process group, stacked on dim 0 in rank
    order (the functional collective DTensor issues, waited on)."""
    mesh, axis = group
    pg = mesh.get_group(axis)
    out = torch.ops._c10d_functional.all_gather_into_tensor(t.contiguous(), pg.size(),
                                                            pg.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


def _nll_rows(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *, tied: bool,
              v0: int = 0, group=None) -> torch.Tensor:
    """The unembedding of x (B, S', d) on the vocabulary w holds (the tied
    embedding (V_r, d), or the unembedding's (d, V_r)) and ``_VocabNLL``."""
    return _VocabNLL.apply(_logits(x, w, tied), labels, v0, group)


def _chunk_nll(params, cfg: LMConfig, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed next-token NLL of hidden states x (B, S', d) against labels (B, S').

    On DTensors the unembedding, the log-sum-exp and the label pick run on
    each rank's local tensors (``local_map``), at placements set here
    rather than by DTensor's rules, which differ by torch version: the rows
    split over every batch axis (``pod`` included), the vocabulary over
    ``model`` (an unembedding that the sharding rules split by its hidden
    dim, granite's vocabulary of 49,155 on 16 ranks, is cut by vocabulary
    first: DTensor's shards of ⌈V / m⌉ ids).  Each rank's logits are
    (B_r, S', V / m), and the weight's gradient is made over the rank's
    own rows and vocabulary shard, a partial sum over the batch axes only.
    On one rank the local function is the plain step's code."""
    tied, w = cfg.tie_embeddings, _unembedding(params, cfg)
    if not isinstance(x, DTensor):
        return _nll_rows(x, w, labels, tied=tied)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    model = names.index("model") if "model" in names else None
    vdim = 0 if tied else 1

    def per_axis(on_model, elsewhere):
        return tuple(on_model if axis == model else elsewhere for axis in range(mesh.ndim))

    rows, vocab = per_axis(Replicate(), Shard(0)), per_axis(Shard(vdim), Replicate())
    m = 1 if model is None else mesh.size(model)
    v0 = 0 if m == 1 else mesh.get_local_rank(model) * -(-w.shape[vdim] // m)
    local = functools.partial(_nll_rows, tied=tied, v0=v0,
                              group=None if m == 1 else (mesh, model))
    return local_map(local, out_placements=list(per_axis(Replicate(), Partial())),
                     in_placements=(rows, vocab, rows),
                     in_grad_placements=(per_axis(Partial(), Shard(0)),
                                         per_axis(Shard(vdim), Partial()), rows),
                     device_mesh=mesh, redistribute_inputs=True)(x, w, labels)


def loss_fn(params, cfg: LMConfig, batch: dict, *, moe_fn=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (B, S), logits in float32, plus 0.01 times the MoE
    layers' auxiliary loss sum (0 for a dense config).  When S is a
    multiple of ``_LOSS_CHUNK`` and longer than it, the unembedding and
    log-softmax run one chunk of the sequence at a time, each under
    activation checkpointing (the reference's ``jax.checkpoint``): peak
    logits memory is (B, chunk, V), and the backward recomputes each
    chunk's logits.  ``moe_fn`` as in ``forward_hidden``."""
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux = forward_hidden(params, cfg, tokens, moe_fn=moe_fn)
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


def _prefill_layer(layer, cfg: LMConfig, x: torch.Tensor, freqs: torch.Tensor, moe_fn=None):
    """One prefill layer: (x after it, (k after RoPE, v), (B, S, Hkv, D)
    each).  ``moe_fn`` as in ``_ffn``."""
    o, k, v = attn_lib.attend(layer["attn"], rms_norm(layer["ln1"], x), n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, causal=True,
                              freqs=freqs)
    x = x + linear(layer["attn"]["wo"], o)
    return x + _ffn(layer, cfg, rms_norm(layer["ln2"], x), moe_fn)[0], (k, v)


def _cache_of(k: torch.Tensor, v: torch.Tensor, s: int, max_len: int) -> dict:
    """A layer's cache of ``max_len`` slots holding a prefill's k, v
    (B, S, Hkv, D) in its first S slots, ``pos`` S.  On DTensors each rank
    pads its shards and the cache is laid out as ``lm_cache_pspecs`` says
    (the batch over the axes the tokens are split on, the KV heads over
    ``model`` where they divide it, else the slots), so that a decode cell
    takes it as it is."""
    def pad(k, v):
        b = k.shape[0]
        cache = attn_lib.init_kv_cache(b, max_len, k.shape[2], k.shape[3], dtype=k.dtype,
                                       device=k.device)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        cache["pos"].fill_(s)
        return cache["k"], cache["v"], cache["pos"]

    if not isinstance(k, DTensor):
        return dict(zip(("k", "v", "pos"), pad(k, v)))
    mesh = k.device_mesh
    names = mesh.mesh_dim_names
    batch = tuple(n for n, p in zip(names, k.placements) if p.is_shard(0))
    model = mesh.size(names.index("model")) if "model" in names else 0
    pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in k.placements)
    pos_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    ck, cv, pos = local_map(pad, out_placements=(list(pl), list(pl), list(pos_pl)),
                            in_placements=(pl, pl), device_mesh=mesh,
                            redistribute_inputs=True)(k, v)
    spec = shd.lm_cache_pspecs({"k": ck}, batch, model_axis_size=model)["['k']"]
    want = shd.to_placements(mesh, spec)
    return {"k": ck.redistribute(mesh, want), "v": cv.redistribute(mesh, want), "pos": pos}


def prefill(params, cfg: LMConfig, tokens: torch.Tensor, max_len: int, *, moe_fn=None):
    """Run the prompt tokens (B, S), fill fresh KV caches of ``max_len``
    slots; returns (last-token logits (B, V), caches with pos = S).
    ``moe_fn`` replaces ``apply_moe`` in the MoE layers (see ``_ffn``).  On
    DTensors (a prefill cell, ``launch/steps.py``) attention's core runs on
    each rank's sequences and heads, and the caches come out at
    ``lm_cache_pspecs``' placements (``_cache_of``)."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit caches of {max_len} slots")
    x = emb_lib.lookup(params["embed"], tokens)
    freqs = _freqs(cfg, x.device)
    caches = []
    for layer in params["layers"]:
        x, (k, v) = _prefill_layer(layer, cfg, x, freqs, moe_fn)
        caches.append(_cache_of(k, v, s, max_len))
    x = rms_norm(params["ln_f"], x[:, -1:])
    return _unembed(params, cfg, x)[:, 0], caches


def decode_step(params, cfg: LMConfig, token: torch.Tensor, caches: list[dict], *,
                moe_fn=None):
    """token (B,) int → (logits (B, V), caches).  One decode step; each
    layer's new K/V are written in place into ``caches`` (the list
    returned holds the same tensors, with ``pos`` advanced by one).
    ``moe_fn`` as in ``prefill``; on DTensor caches (a decode cell) see
    ``layers.attention.decode_attention``."""
    x = emb_lib.lookup(params["embed"], token)[:, None]              # (B, 1, D)
    freqs = _freqs(cfg, x.device)
    new_caches = []
    for layer, cache in zip(params["layers"], caches):
        h, cache = attn_lib.decode_attention(
            layer["attn"], rms_norm(layer["ln1"], x), cache, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, freqs=freqs)
        x = x + h
        x = x + _ffn(layer, cfg, rms_norm(layer["ln2"], x), moe_fn)[0]
        new_caches.append(cache)
    x = rms_norm(params["ln_f"], x)
    return _unembed(params, cfg, x)[:, 0], new_caches
