"""Synthetic recommendation batches with a planted learnable signal, LM
token streams, and graphs (community-structured random graphs, their CSR,
batches of small graphs).

Everything here is numpy on the host: a serving runtime pads a request on
the host and moves the padded request to the device in one step.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.models.lm import LMConfig
from repro_torch.models.recsys import RecConfig


def recsys_layout(cfg: RecConfig, batch: int, *, n_candidates: int = 0,
                  with_label: bool = True) -> dict[str, tuple[tuple, Any]]:
    """name → (shape, numpy dtype) for every input leaf."""
    out: dict[str, tuple[tuple, Any]] = {}
    if cfg.n_dense:
        out["dense"] = ((batch, cfg.n_dense), np.float32)
    if cfg.n_tables:
        out["sparse"] = ((batch, cfg.n_tables, cfg.hotness), np.int32)
    if cfg.has_history:
        out["history"] = ((batch, cfg.seq_len), np.int32)
        out["hist_mask"] = ((batch, cfg.seq_len), np.bool_)
        if n_candidates == 0:
            out["target"] = ((batch,), np.int32)
    if n_candidates:
        out["candidates"] = ((batch, n_candidates), np.int32)
    if with_label and not n_candidates:
        shape = (batch,) if cfg.n_tasks == 1 else (batch, cfg.n_tasks)
        out["label"] = (shape, np.float32)
    return out


def recsys_batch(rng: np.random.Generator, cfg: RecConfig, batch: int, *,
                 n_candidates: int = 0, with_label: bool = True) -> dict:
    """Real batch with a planted signal: the label depends linearly on the
    dense features and on a per-id latent propensity.  Ids are Zipf-skewed
    (the production embedding access pattern)."""
    out: dict = {}
    logit = np.zeros(batch, np.float32)
    if cfg.n_dense:
        dense = rng.normal(size=(batch, cfg.n_dense)).astype(np.float32)
        w = _planted_w(cfg.n_dense)
        logit += dense @ w
        out["dense"] = dense
    if cfg.n_tables:
        sparse = _zipf_ids(rng, (batch, cfg.n_tables, cfg.hotness), cfg.vocab)
        logit += ((sparse.sum(axis=(1, 2)) % 7) - 3) * 0.3
        out["sparse"] = sparse.astype(np.int32)
    if cfg.has_history:
        hist = _zipf_ids(rng, (batch, cfg.seq_len), cfg.item_vocab)
        out["history"] = hist.astype(np.int32)
        lengths = rng.integers(1, cfg.seq_len + 1, size=batch)
        out["hist_mask"] = (np.arange(cfg.seq_len)[None] < lengths[:, None])
        if n_candidates == 0:
            tgt = _zipf_ids(rng, (batch,), cfg.item_vocab).astype(np.int32)
            out["target"] = tgt
            logit += ((tgt % 5) - 2) * 0.2
    if n_candidates:
        out["candidates"] = _zipf_ids(
            rng, (batch, n_candidates), cfg.item_vocab or cfg.vocab).astype(np.int32)
    if with_label and not n_candidates:
        p = 1.0 / (1.0 + np.exp(-logit))
        lab = (rng.random(batch) < p).astype(np.float32)
        if cfg.n_tasks > 1:
            lab = np.stack([lab] + [(rng.random(batch) < p).astype(np.float32)
                                    for _ in range(cfg.n_tasks - 1)], axis=1)
        out["label"] = lab
    return out


def _planted_w(n: int) -> np.ndarray:
    r = np.random.default_rng(1234)
    return (r.normal(size=n) / np.sqrt(n)).astype(np.float32)


def _zipf_ids(rng, shape, vocab: int) -> np.ndarray:
    """Zipf-ish ids in [0, vocab): heavy head, long tail."""
    u = rng.random(size=shape)
    ids = np.floor(vocab ** u).astype(np.int64) - 1
    return np.clip(ids, 0, vocab - 1)


# ---------------------------------------------------------------------- lm


def lm_batch(rng: np.random.Generator, cfg: LMConfig, batch: int, seq: int) -> dict:
    """Markov-chain token stream (learnable next-token structure): tokens
    and next-token labels, (B, S) int32 each.  Draws from ``rng`` in the
    JAX package's order, so one seed gives both packages the same tokens."""
    v = cfg.vocab
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, v, size=batch)
    noise = rng.random(size=(batch, seq)) < 0.15
    rand = rng.integers(0, v, size=(batch, seq))
    for t in range(seq):
        nxt = (toks[:, t] * 31 + 17) % v
        toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


# --------------------------------------------------------------------- gnn


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int, n_classes: int) -> dict:
    """Community-structured random graph: features and labels correlate, so
    GCN training measurably improves accuracy.  x (N, d_feat) float32,
    edge_index (2, E) int32, labels (N,) int32, train_mask (N,) bool; draws
    from ``rng`` in the JAX package's order, so one seed gives both packages
    the same graph."""
    comm = rng.integers(0, n_classes, size=n_nodes)
    # ~80% intra-community edges
    src = rng.integers(0, n_nodes, size=n_edges)
    intra = rng.random(n_edges) < 0.8
    dst = np.where(
        intra,
        _same_comm_partner(rng, comm, src, n_classes, n_nodes),
        rng.integers(0, n_nodes, size=n_edges))
    x = np.eye(n_classes, dtype=np.float32)[comm]
    x = np.pad(x, ((0, 0), (0, max(0, d_feat - n_classes))))[:, :d_feat]
    x = x + rng.normal(scale=0.5, size=x.shape).astype(np.float32)
    mask = rng.random(n_nodes) < 0.6
    return {"x": x, "edge_index": np.stack([src, dst]).astype(np.int32),
            "labels": comm.astype(np.int32), "train_mask": mask}


def _same_comm_partner(rng, comm, src, n_classes, n_nodes):
    # a random node of src's community: nodes are unordered, so resample
    # from the nodes with a matching label
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(n_classes), side="left")
    ends = np.searchsorted(sorted_comm, np.arange(n_classes), side="right")
    c = comm[src]
    lo, hi = starts[c], np.maximum(ends[c], starts[c] + 1)
    pick = lo + (rng.random(len(src)) * (hi - lo)).astype(np.int64)
    return order[np.minimum(pick, n_nodes - 1)]


def graph_to_csr(n_nodes: int, edge_index: np.ndarray):
    """(indptr (N + 1,), indices (E,)): each node's sources, edges sorted by
    destination with a stable sort."""
    src, dst = np.asarray(edge_index)
    order = np.argsort(dst, kind="stable")
    indices = src[order]
    indptr = np.searchsorted(dst[order], np.arange(n_nodes + 1))
    return indptr, indices


def molecule_batch(rng: np.random.Generator, batch: int, n_nodes: int,
                   n_edges: int, d_feat: int, n_classes: int) -> dict:
    """``batch`` small random graphs: x (G, N, F) float32, edge_index (G, 2,
    E) int32, node_mask (G, N) bool, labels (G,) int32; the label is the
    sign of the mean feature (learnable)."""
    x = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
    ei = rng.integers(0, n_nodes, size=(batch, 2, n_edges)).astype(np.int32)
    mask = np.ones((batch, n_nodes), bool)
    labels = (x.mean(axis=(1, 2)) > 0).astype(np.int32)
    return {"x": x, "edge_index": ei, "node_mask": mask, "labels": labels}
