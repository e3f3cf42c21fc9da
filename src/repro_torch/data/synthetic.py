"""Synthetic recommendation batches with a planted learnable signal.

Everything here is numpy on the host: a serving runtime pads a request on
the host and moves the padded request to the device in one step.
"""
from __future__ import annotations

from typing import Any

import numpy as np

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
