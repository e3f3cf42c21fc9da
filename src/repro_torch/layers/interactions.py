"""Feature-interaction operators of the eight paper models.

* ``dot_interaction``   — DLRM pairwise dots (RMC1/2/3)
* ``gmf``               — NCF generalized matrix factorization
* ``fm_interaction``    — factorization-machine pooling
* ``din_attention``     — DIN local activation unit

(``concat`` is a reshape inside ``models.recsys.forward``.)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.layers.mlp import init_mlp, mlp


def dot_interaction(feats: torch.Tensor, *, keep_self: bool = False) -> torch.Tensor:
    """feats (B, F, D) → (B, F(F-1)/2) pairwise dot products (lower
    triangle, ``tril_indices`` order); with ``keep_self`` the diagonal is
    kept too, (B, F(F+1)/2).

    The strict triangle is the hand-written kernel's job
    (``kernels.ops.dot_interaction``); the ``keep_self`` variant, which no
    paper model uses, is plain tensor code.
    """
    if not keep_self:
        return ops.dot_interaction(feats.contiguous())
    f = feats.shape[1]
    z = torch.einsum("bfd,bgd->bfg", feats, feats)
    li, lj = torch.tril_indices(f, f, offset=0, device=feats.device)
    return z[:, li, lj]


def gmf(user: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
    """NCF generalized MF: elementwise product of user/item embeddings."""
    return user * item


def fm_interaction(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, D): ½((Σᵢvᵢ)² − Σᵢvᵢ²)."""
    s = feats.sum(dim=1)
    sq = (feats * feats).sum(dim=1)
    return 0.5 * (s * s - sq)


def init_din_attention(generator: torch.Generator, dim: int, hidden=(80, 40), *,
                       dtype: torch.dtype = torch.float32, device: torch.device | str):
    return init_mlp(generator, 4 * dim, list(hidden) + [1], dtype=dtype, device=device)


def din_attention(params, history: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """DIN local activation unit.

    history (B, T, D), target (B, D) → (B, D) attention-weighted sum-pool.
    Scores come from MLP([h, t, h−t, h·t]) with sigmoid between layers;
    masked positions are set to −1e9 *after* the MLP and the softmax runs
    in float32.
    """
    tgt = target[:, None, :].expand_as(history)
    feats = torch.cat([history, tgt, history - tgt, history * tgt], dim=-1)
    scores = mlp(params, feats, act="sigmoid")[..., 0]               # (B, T)
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    w = torch.softmax(scores.float(), dim=-1).to(history.dtype)
    return torch.einsum("bt,btd->bd", w, history)
