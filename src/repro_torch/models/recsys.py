"""Generalized neural recommendation model (paper Fig. 2), serving side.

One configurable architecture realizes the eight paper models (NCF, WnD,
MT-WnD, DLRM-RMC1/2/3, DIN, DIEN): dense-FC stack, per-field embedding
bags, a pluggable feature-interaction op, and predict-FC stack(s).
Parameters are a plain dictionary of tensors with the JAX package's keys
and layouts, so ``compat.from_jax_params`` weights drop in.

``forward`` sends the embedding pooling and the DLRM dot interaction
through ``kernels.ops``: on the GPU the hand-written kernels serve.

Batch layout (tensors on the parameters' device):
    dense      (B, n_dense)            float   — continuous features
    sparse     (B, F, H)               int32   — H lookups per field
    history    (B, T)                  int32   — behavior sequence (DIN/DIEN)
    hist_mask  (B, T)                  bool
    target     (B,)                    int32   — candidate item id
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.layers import embedding as emb_lib
from repro_torch.layers import interactions as ix
from repro_torch.layers import rnn as rnn_lib
from repro_torch.layers.mlp import init_linear, init_mlp, linear, mlp

# interactions of the JAX package's wider model zoo that arrive with the
# CIN kernel and the attention layers
_LATER_SLICE = ("cin", "self-attn", "mind", "bidir-seq")


@dataclasses.dataclass(frozen=True)
class RecConfig:
    name: str
    interaction: str                     # concat|dot|gmf|fm|din|dien (later: cin|self-attn|mind|bidir-seq)
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


def _not_ported(cfg: RecConfig) -> NotImplementedError:
    return NotImplementedError(
        f"interaction {cfg.interaction!r} ({cfg.name}) is not ported yet: it arrives "
        f"with the CIN kernel and the rest of the recsys zoo in a later slice")


# ------------------------------------------------------------------- init


def init(generator: torch.Generator, cfg: RecConfig, *,
         device: torch.device | str | None = None):
    """Random parameters on ``device`` (the GPU unless the caller passes
    one); ``generator`` must live on the same device.  Tables are drawn
    directly into their stacked ``(F, V, D)`` tensor, never on the host."""
    if cfg.interaction in _LATER_SLICE:
        raise _not_ported(cfg)
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

    if cfg.interaction == "din":
        p["din"] = ix.init_din_attention(generator, cfg.embed_dim, **kw)
    elif cfg.interaction == "dien":
        p["gru"] = rnn_lib.init_gru(generator, cfg.embed_dim, cfg.gru_hidden, **kw)
        p["augru"] = rnn_lib.init_gru(generator, cfg.gru_hidden, cfg.gru_hidden, **kw)
        p["att_score"] = init_linear(generator, cfg.gru_hidden + cfg.embed_dim, 1, **kw)

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
    if cfg.interaction == "din":                      # pooled hist + target + tables
        return (2 + cfg.n_tables) * cfg.embed_dim
    if cfg.interaction == "dien":
        return cfg.gru_hidden + (1 + cfg.n_tables) * cfg.embed_dim
    if cfg.interaction in _LATER_SLICE:
        raise _not_ported(cfg)
    raise ValueError(cfg.interaction)


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
    if it in _LATER_SLICE:
        raise _not_ported(cfg)

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
    else:
        raise ValueError(it)

    outs = [mlp(pp, z, act="relu") for pp in params["predict"]]
    out = torch.cat(outs, dim=-1) if cfg.n_tasks > 1 else outs[0]
    return out[..., 0] if cfg.n_tasks == 1 else out
