"""Generalized neural recommendation model (paper Fig. 2), serving side.

One configurable architecture realizes the eight paper models (NCF, WnD,
MT-WnD, DLRM-RMC1/2/3, DIN, DIEN) and the rest of the recsys zoo
(xDeepFM, AutoInt, MIND, BERT4Rec): dense-FC stack, per-field embedding
bags, a pluggable feature-interaction op, and predict-FC stack(s).
Parameters are a plain dictionary of tensors with the JAX package's keys
and layouts, so ``compat.from_jax_params`` weights drop in.

``forward`` sends the embedding pooling, the DLRM dot interaction and the
xDeepFM CIN layers through ``kernels.ops``: on the GPU the hand-written
kernels serve.

Batch layout (tensors on the parameters' device):
    dense      (B, n_dense)            float   — continuous features
    sparse     (B, F, H)               int32   — H lookups per field
    history    (B, T)                  int32   — behavior sequence (DIN/DIEN/
                                                 MIND/BERT4Rec)
    hist_mask  (B, T)                  bool
    target     (B,)                    int32   — candidate item id
    candidates (B, C)                  int32   — retrieval scoring
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import interactions as ix
from repro_torch.layers import rnn as rnn_lib
from repro_torch.layers.mlp import init_linear, init_mlp, linear, mlp
from repro_torch.layers.norms import init_layer_norm, layer_norm


@dataclasses.dataclass(frozen=True)
class RecConfig:
    name: str
    interaction: str                     # concat|dot|gmf|fm|cin|self-attn|din|dien|mind|bidir-seq
    n_dense: int = 0
    dense_fc: Sequence[int] = ()
    predict_fc: Sequence[int] = (256, 64, 1)
    n_tasks: int = 1
    # sparse fields
    n_tables: int = 0
    vocab: int = 100_000
    embed_dim: int = 32
    hotness: int = 1
    pooling: str = "sum"
    # sequence models
    seq_len: int = 0
    item_vocab: int = 0
    # CIN (xDeepFM)
    cin_layers: Sequence[int] = ()
    dnn_widths: Sequence[int] = ()
    # AutoInt
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # MIND
    n_interests: int = 0
    capsule_iters: int = 3
    # DIEN
    gru_hidden: int = 0
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def has_history(self) -> bool:
        return self.interaction in ("din", "dien", "mind", "bidir-seq")


# ------------------------------------------------------------------- init


def init(generator: torch.Generator, cfg: RecConfig, *,
         device: torch.device | str | None = None):
    """Random parameters on ``device`` (the GPU unless the caller passes
    one); ``generator`` must live on the same device.  Tables are drawn
    directly into their stacked ``(F, V, D)`` tensor, never on the host."""
    device = resolve(device)
    dt = cfg.tdtype
    kw = dict(dtype=dt, device=device)
    p: dict = {}
    if cfg.n_tables:
        # stacked tables (F, V, D), drawn as one (F·V, D) table
        p["tables"] = emb_lib.init_table(
            generator, cfg.n_tables * cfg.vocab, cfg.embed_dim, **kw
        ).view(cfg.n_tables, cfg.vocab, cfg.embed_dim)
    if cfg.has_history:
        p["item_table"] = emb_lib.init_table(generator, cfg.item_vocab, cfg.embed_dim, **kw)
    if cfg.dense_fc:
        p["dense_mlp"] = init_mlp(generator, cfg.n_dense, cfg.dense_fc, **kw)

    it = cfg.interaction
    if it == "cin":
        f = _num_feature_rows(cfg)
        p["cin"] = ix.init_cin(generator, f, cfg.embed_dim, cfg.cin_layers, **kw)
        p["cin_linear"] = init_linear(generator, sum(cfg.cin_layers), 1, **kw)
        p["dnn"] = init_mlp(generator, f * cfg.embed_dim, list(cfg.dnn_widths) + [1], **kw)
        p["lin_w"] = torch.zeros((cfg.n_tables,), **kw)              # linear logit term
    elif it == "self-attn":
        p["attn"] = []
        dim = cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            p["attn"].append(ix.init_autoint_layer(generator, dim, cfg.n_heads, cfg.d_attn, **kw))
            dim = cfg.n_heads * cfg.d_attn                           # width grows after layer 1
    elif it == "din":
        p["din"] = ix.init_din_attention(generator, cfg.embed_dim, **kw)
    elif it == "dien":
        p["gru"] = rnn_lib.init_gru(generator, cfg.embed_dim, cfg.gru_hidden, **kw)
        p["augru"] = rnn_lib.init_gru(generator, cfg.gru_hidden, cfg.gru_hidden, **kw)
        p["att_score"] = init_linear(generator, cfg.gru_hidden + cfg.embed_dim, 1, **kw)
    elif it == "mind":
        p["capsule"] = ix.init_capsule_routing(generator, cfg.embed_dim, **kw)
    elif it == "bidir-seq":
        p["pos_emb"] = torch.randn((cfg.seq_len, cfg.embed_dim), generator=generator,
                                   device=device).mul_(0.02).to(dt)
        hd = cfg.embed_dim // cfg.n_heads
        p["blocks"] = [{
            "ln1": init_layer_norm(cfg.embed_dim, dt, device=device),
            "attn": attn_lib.init_attention(generator, cfg.embed_dim, cfg.n_heads,
                                            cfg.n_heads, hd, **kw),
            "ln2": init_layer_norm(cfg.embed_dim, dt, device=device),
            "ffn": init_mlp(generator, cfg.embed_dim, [4 * cfg.embed_dim, cfg.embed_dim], **kw),
        } for _ in range(cfg.n_attn_layers)]
        p["ln_f"] = init_layer_norm(cfg.embed_dim, dt, device=device)

    if it != "cin":                                   # xDeepFM carries its own heads
        d_int = _interaction_dim(cfg)
        p["predict"] = [init_mlp(generator, d_int, list(cfg.predict_fc), **kw)
                        for _ in range(cfg.n_tasks)]
    return p


def _num_feature_rows(cfg: RecConfig) -> int:
    """Rows entering a (B, F', D) interaction: per-table pooled + dense row."""
    extra = 1 if cfg.dense_fc else 0
    return cfg.n_tables + extra


def _interaction_dim(cfg: RecConfig) -> int:
    dense_out = (cfg.dense_fc[-1] if cfg.dense_fc else cfg.n_dense)
    if cfg.interaction == "concat":
        return dense_out + cfg.n_tables * cfg.embed_dim
    if cfg.interaction == "gmf":                      # NCF: gmf ⊕ mlp-concat
        return cfg.embed_dim + 2 * cfg.embed_dim
    if cfg.interaction == "dot":
        f = _num_feature_rows(cfg)
        return f * (f - 1) // 2 + dense_out
    if cfg.interaction == "fm":
        return cfg.embed_dim + dense_out
    if cfg.interaction == "self-attn":
        return cfg.n_tables * cfg.n_heads * cfg.d_attn
    if cfg.interaction == "din":                      # pooled hist + target + tables
        return (2 + cfg.n_tables) * cfg.embed_dim
    if cfg.interaction == "dien":
        return cfg.gru_hidden + (1 + cfg.n_tables) * cfg.embed_dim
    if cfg.interaction == "mind":
        return 2 * cfg.embed_dim                      # interest ⊕ target
    if cfg.interaction == "bidir-seq":
        return cfg.embed_dim
    raise ValueError(f"unknown interaction {cfg.interaction!r}")


# ---------------------------------------------------------------- forward


def _sparse_pooled(params, cfg: RecConfig, sparse: torch.Tensor) -> torch.Tensor:
    """sparse (B, F, H) → (B, F, D) per-table pooled embeddings: all F
    tables in one ``ops.embedding_bag`` launch."""
    tables = params["tables"]                                        # (F, V, D)
    if cfg.pooling in ("sum", "mean"):
        return ops.embedding_bag(tables, sparse.contiguous(), mode=cfg.pooling)
    if cfg.pooling == "concat":                                      # hotness-1 concat
        field = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
        rows = tables[field, sparse.long()]                          # (B, F, H, D)
        b, f, h, d = rows.shape
        return rows.reshape(b, f, h * d)
    raise ValueError(cfg.pooling)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


@torch.inference_mode()
def forward(params, cfg: RecConfig, batch: dict) -> torch.Tensor:
    """→ CTR logits (B,) (or (B, n_tasks) for multi-task models)."""
    it = cfg.interaction
    dense_out = None
    if cfg.n_dense:
        dense_out = batch["dense"].to(cfg.tdtype)
        if cfg.dense_fc:
            dense_out = mlp(params["dense_mlp"], dense_out, act="relu",
                            final_act="relu")

    emb = _sparse_pooled(params, cfg, batch["sparse"]) if cfg.n_tables else None

    if it == "concat":
        parts = [] if dense_out is None else [dense_out]
        parts.append(emb.reshape(emb.shape[0], -1))
        z = torch.cat(parts, dim=-1)
    elif it == "gmf":                                 # NCF: tables [u_mf,i_mf,u_mlp,i_mlp]
        z = torch.cat([ix.gmf(emb[:, 0], emb[:, 1]), emb[:, 2], emb[:, 3]], dim=-1)
    elif it == "dot":
        feats = emb
        if dense_out is not None:
            feats = torch.cat([dense_out[:, None, :], emb], dim=1)
        z = torch.cat([ix.dot_interaction(feats)]
                      + ([] if dense_out is None else [dense_out]), dim=-1)
    elif it == "fm":
        z = ix.fm_interaction(emb)
        if dense_out is not None:
            z = torch.cat([z, dense_out], dim=-1)
    elif it == "cin":
        return _xdeepfm_forward(params, cfg, emb)
    elif it == "self-attn":
        x = emb
        for lp in params["attn"]:
            x = ix.autoint_layer(lp, x, n_heads=cfg.n_heads, d_attn=cfg.d_attn)
        z = x.reshape(x.shape[0], -1)
    elif it == "din":
        hist = _take(params["item_table"], batch["history"])
        tgt = _take(params["item_table"], batch["target"])
        pooled = ix.din_attention(params["din"], hist, tgt,
                                  mask=batch.get("hist_mask"))
        parts = [pooled, tgt]
        if emb is not None:
            parts.append(emb.reshape(emb.shape[0], -1))
        z = torch.cat(parts, dim=-1)
    elif it == "dien":
        hist = _take(params["item_table"], batch["history"])
        tgt = _take(params["item_table"], batch["target"])
        hs = rnn_lib.gru(params["gru"], hist)                        # (B, T, Hg)
        att_in = torch.cat([hs, tgt[:, None].expand(-1, hist.shape[1], -1)], dim=-1)
        scores = torch.sigmoid(linear(params["att_score"], att_in))[..., 0]
        if "hist_mask" in batch:
            scores = scores * batch["hist_mask"].to(scores.dtype)
        h_last = rnn_lib.augru(params["augru"], hs, scores)          # (B, Hg)
        parts = [h_last, tgt]
        if emb is not None:
            parts.append(emb.reshape(emb.shape[0], -1))
        z = torch.cat(parts, dim=-1)
    elif it == "mind":
        caps = _mind_interests(params, cfg, batch)                   # (B, K, D)
        tgt = _take(params["item_table"], batch["target"])
        # label-aware attention (pow 2 sharpening), then soft-pool interests
        scores = torch.einsum("bkd,bd->bk", caps, tgt) / math.sqrt(cfg.embed_dim)
        w = torch.softmax(scores.float() * 2.0, dim=-1)
        interest = torch.einsum("bk,bkd->bd", w.to(caps.dtype), caps)
        z = torch.cat([interest, tgt], dim=-1)
    elif it == "bidir-seq":
        h = _bert4rec_encode(params, cfg, batch)                     # (B, T, D)
        # score the target item at the final position (next-item inference)
        z = h[:, -1] * _take(params["item_table"], batch["target"])
    else:
        raise ValueError(f"unknown interaction {it!r}")

    outs = [mlp(pp, z, act="relu") for pp in params["predict"]]
    out = torch.cat(outs, dim=-1) if cfg.n_tasks > 1 else outs[0]
    return out[..., 0] if cfg.n_tasks == 1 else out


def _xdeepfm_forward(params, cfg: RecConfig, emb: torch.Tensor) -> torch.Tensor:
    """CIN logit + DNN logit + linear logit (divided by ``embed_dim``);
    xDeepFM has no predict heads."""
    b = emb.shape[0]
    cin_out = ix.cin(params["cin"], emb)                             # (B, ΣH)
    logit_cin = linear(params["cin_linear"], cin_out)[..., 0]
    logit_dnn = mlp(params["dnn"], emb.reshape(b, -1), act="relu")[..., 0]
    logit_lin = torch.einsum("bfd,f->b", emb, params["lin_w"]) / cfg.embed_dim
    return logit_cin + logit_dnn + logit_lin


def _mind_interests(params, cfg: RecConfig, batch: dict) -> torch.Tensor:
    hist = _take(params["item_table"], batch["history"])
    return ix.capsule_routing(params["capsule"], hist, n_interests=cfg.n_interests,
                              n_iters=cfg.capsule_iters, mask=batch.get("hist_mask"))


def _bert4rec_encode(params, cfg: RecConfig, batch: dict) -> torch.Tensor:
    """Bidirectional encoder over the history; ``hist_mask`` is not read
    (the reference ignores it too)."""
    x = _take(params["item_table"], batch["history"])
    x = x + params["pos_emb"][None, : x.shape[1]]
    hd = cfg.embed_dim // cfg.n_heads
    for blk in params["blocks"]:
        x = x + attn_lib.attention(blk["attn"], layer_norm(blk["ln1"], x), n_heads=cfg.n_heads,
                                   n_kv_heads=cfg.n_heads, head_dim=hd, causal=False)
        x = x + mlp(blk["ffn"], layer_norm(blk["ln2"], x), act="gelu")
    return layer_norm(params["ln_f"], x)


@torch.inference_mode()
def bulk_forward(params, cfg: RecConfig, batch: dict, *, chunk: int = 16_384) -> torch.Tensor:
    """Offline/bulk scoring in chunks of the batch, so the interaction
    intermediates are never built for a 262k/1M-row batch at once.  The
    chunk is rounded down to a divisor of the batch (the reference's rule:
    the fewest chunks ``n >= ceil(B / chunk)`` with ``B % n == 0``)."""
    b = next(iter(batch.values())).shape[0]
    if b <= chunk:
        return forward(params, cfg, batch)
    n = -(-b // chunk)
    while b % n:
        n += 1
    chunk = b // n
    outs = [forward(params, cfg, {k: v[i * chunk:(i + 1) * chunk] for k, v in batch.items()})
            for i in range(n)]
    return torch.cat(outs, dim=0)


@torch.inference_mode()
def score_candidates(params, cfg: RecConfig, batch: dict) -> torch.Tensor:
    """Retrieval scoring: (B, C) scores for B users × C candidate items, as
    batched products.  MIND scores the max over interest capsules;
    BERT4Rec the dot of the final hidden state with each candidate."""
    cand = _take(params["item_table"], batch["candidates"])          # (B, C, D)
    if cfg.interaction == "mind":
        caps = _mind_interests(params, cfg, batch)                   # (B, K, D)
        return torch.einsum("bkd,bcd->bkc", caps, cand).amax(dim=1)
    if cfg.interaction == "bidir-seq":
        h = _bert4rec_encode(params, cfg, batch)[:, -1]              # (B, D)
        return torch.einsum("bd,bcd->bc", h, cand)
    raise ValueError(f"{cfg.name} has no two-tower retrieval head")
