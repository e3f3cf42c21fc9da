"""Analytic per-sample compute/memory costs per model family.

Feeds (a) the accelerator device model (compute & transfer terms), and
(b) the roofline MODEL_FLOPS ratio (6·N·D dense / 6·N_active·D MoE).
"""
from __future__ import annotations

from repro_torch.models.lm import LMConfig
from repro_torch.models.recsys import RecConfig


def _mlp_flops(d_in: int, widths) -> int:
    f = 0
    prev = d_in
    for w in widths:
        f += 2 * prev * w
        prev = w
    return f


def recsys_flops_per_sample(cfg: RecConfig) -> int:
    """Forward-pass MAC-based FLOPs for one candidate item."""
    f = 0
    dense_out = cfg.n_dense
    if cfg.dense_fc:
        f += _mlp_flops(cfg.n_dense, cfg.dense_fc)
        dense_out = cfg.dense_fc[-1]
    d, F = cfg.embed_dim, cfg.n_tables
    it = cfg.interaction
    if it == "dot":
        rows = F + (1 if cfg.dense_fc else 0)
        f += 2 * rows * rows * d
    elif it == "cin":
        h_prev = F
        for h in cfg.cin_layers:
            f += 2 * h_prev * F * d * h
            h_prev = h
        f += _mlp_flops(F * d, list(cfg.dnn_widths) + [1])
    elif it == "self-attn":
        dim = d
        for _ in range(cfg.n_attn_layers):
            dh = cfg.n_heads * cfg.d_attn
            f += 2 * F * dim * 3 * dh + 2 * F * F * dh * 2 + 2 * F * dim * dh
            dim = dh
    elif it == "din":
        f += _mlp_flops(4 * d, (80, 40, 1)) * cfg.seq_len
    elif it == "dien":
        g = cfg.gru_hidden
        f += cfg.seq_len * (6 * d * g + 6 * g * g) * 2      # GRU + AUGRU
    elif it == "mind":
        f += cfg.capsule_iters * 2 * cfg.seq_len * cfg.n_interests * d
        f += 2 * cfg.seq_len * d * d                         # bilinear map
    elif it == "bidir-seq":
        dim = cfg.embed_dim
        per_block = 8 * cfg.seq_len * dim * dim + 4 * cfg.seq_len * cfg.seq_len * dim
        f += cfg.n_attn_layers * per_block
    if it != "cin":
        d_int = _safe_interaction_dim(cfg, dense_out)
        f += cfg.n_tasks * _mlp_flops(d_int, cfg.predict_fc)
    return int(f)


def _safe_interaction_dim(cfg: RecConfig, dense_out: int) -> int:
    from repro_torch.models.recsys import _interaction_dim
    try:
        return _interaction_dim(cfg)
    except ValueError:
        return dense_out


def recsys_embed_bytes_per_sample(cfg: RecConfig, itemsize: int = 4) -> int:
    """Embedding-table bytes touched per candidate (the irregular-access
    traffic that makes RMC1/2 and DIN memory-bound in paper Fig. 3)."""
    b = cfg.n_tables * cfg.hotness * cfg.embed_dim * itemsize
    if cfg.has_history:
        b += (cfg.seq_len + 1) * cfg.embed_dim * itemsize
    return int(b)


def recsys_activation_bytes_per_sample(cfg: RecConfig, itemsize: int = 4) -> int:
    b = cfg.n_dense * itemsize
    b += cfg.n_tables * cfg.embed_dim * itemsize
    return int(b)


def lm_flops_per_token(cfg: LMConfig, *, train: bool = False) -> int:
    n = cfg.active_param_count
    return int((6 if train else 2) * n)


def lm_model_flops(cfg: LMConfig, tokens: int, *, train: bool) -> int:
    """The §Roofline MODEL_FLOPS convention: 6·N·D (train) / 2·N·D (infer),
    N = active params, D = tokens."""
    return lm_flops_per_token(cfg, train=train) * tokens


def gcn_flops(cfg, n_nodes: int, n_edges: int) -> int:
    """``cfg``: any object with ``d_feat``, ``d_hidden``, ``n_classes`` and
    ``n_layers`` (the port has no GNN model yet, so no ``GCNConfig``)."""
    f = 0
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    for i in range(cfg.n_layers):
        f += 2 * n_edges * dims[i]          # message gather+scale+scatter
        f += 2 * n_nodes * dims[i] * dims[i + 1]
    return int(f)
