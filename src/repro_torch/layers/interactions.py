"""Feature-interaction operators of the recommendation model zoo.

* ``dot_interaction``   — DLRM pairwise dots (RMC1/2/3)
* ``gmf``               — NCF generalized matrix factorization
* ``fm_interaction``    — factorization-machine pooling
* ``cross_network``     — DCN (kept for completeness / ablations)
* ``cin``               — xDeepFM Compressed Interaction Network
* ``autoint_layer``     — AutoInt multi-head self-attention over fields
* ``din_attention``     — DIN local activation unit
* ``capsule_routing``   — MIND multi-interest dynamic routing (B2I)

(``concat`` is a reshape inside ``models.recsys.forward``.)
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.layers.mlp import init_linear, init_mlp, linear, mlp


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


def init_cross_network(generator: torch.Generator, dim: int, n_layers: int, *,
                       dtype: torch.dtype = torch.float32, device: torch.device | str):
    return [init_linear(generator, dim, dim, bias=True, dtype=dtype, device=device)
            for _ in range(n_layers)]


def cross_network(params, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for p in params:
        x = x0 * linear(p, x) + x
    return x


def init_cin(generator: torch.Generator, n_fields: int, dim: int, layer_sizes, *,
             dtype: torch.dtype = torch.float32, device: torch.device | str):
    """CIN filters: layer k maps (H_{k-1} × F) interaction maps → H_k, as
    ``(H_{k-1}·F, H_k)`` matrices.  ``dim`` (D) does not enter the shapes."""
    params = []
    h_prev = n_fields
    for h in layer_sizes:
        k = h_prev * n_fields
        w = torch.randn((k, h), generator=generator, device=device) * (1.0 / k) ** 0.5
        params.append(w.to(dtype))
        h_prev = h
    return params


class _FanOut(torch.autograd.Function):
    """``x`` once for each of ``n`` uses.  The backward adds the uses'
    gradients in the order of the uses, so that x's gradient does not depend
    on the order in which autograd finishes them: DTensor's routes put nodes
    of their own before each use and change that order, and a sum taken in
    another order is other bits."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return total, None


def fan_out(x: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """``n`` uses of ``x`` whose gradients are added in order (``_FanOut``);
    without autograd, ``x`` itself ``n`` times."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FanOut.apply(x, n)
    return (x,) * n


def cin(params, x0: torch.Tensor) -> torch.Tensor:
    """x0 (B, F, D) → (B, ΣH_k) sum-pooled feature maps.

    ``x^k[b,h,d] = Σ_{i,j} W^k[i·F+j, h] · x^{k-1}[b,i,d] · x^0[b,j,d]``: one
    ``kernels.ops.cin_layer`` per layer (the hand-written kernel on the
    GPU, and its backward kernel when a gradient is needed; the JAX
    package's layer never reaches its Pallas kernel), then the sum over
    ``D``.  The first layer takes x0 as both inputs; x0's gradients from
    its uses are added in a fixed order (``fan_out``)."""
    xk, *x0s = fan_out(x0.contiguous(), len(params) + 1)
    outs = []
    for w, x0_k in zip(params, x0s):
        xk = ops.cin_layer(x0_k, xk, w)                              # (B, H_k, D)
        outs.append(xk.sum(dim=-1))
    return torch.cat(outs, dim=-1)


def init_autoint_layer(generator: torch.Generator, dim: int, n_heads: int, d_attn: int, *,
                       dtype: torch.dtype = torch.float32, device: torch.device | str):
    kw = dict(bias=False, dtype=dtype, device=device)
    return {name: init_linear(generator, dim, n_heads * d_attn, **kw)
            for name in ("wq", "wk", "wv", "wres")}


def autoint_layer(params, x: torch.Tensor, *, n_heads: int, d_attn: int) -> torch.Tensor:
    """x (B, F, D) → (B, F, n_heads·d_attn): interacting self-attention with
    a residual projection and ReLU."""
    b, f, _ = x.shape
    q = linear(params["wq"], x).reshape(b, f, n_heads, d_attn)
    k = linear(params["wk"], x).reshape(b, f, n_heads, d_attn)
    v = linear(params["wv"], x).reshape(b, f, n_heads, d_attn)
    logits = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(d_attn)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhfg,bghd->bfhd", probs, v).reshape(b, f, n_heads * d_attn)
    return torch.relu(out + linear(params["wres"], x))


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


def init_capsule_routing(generator: torch.Generator, dim: int, *,
                         dtype: torch.dtype = torch.float32, device: torch.device | str):
    """The bilinear map S (dim, dim) shared by all interests (MIND's B2I)."""
    s = torch.randn((dim, dim), generator=generator, device=device) * (1.0 / dim) ** 0.5
    return {"s": s.to(dtype)}


def _squash(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = (x * x).sum(dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def capsule_routing(params, history: torch.Tensor, *, n_interests: int, n_iters: int = 3,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """MIND behaviour-to-interest dynamic routing: history (B, T, D) →
    interest capsules (B, K, D).

    The routing softmax runs over the *interest* axis (dim 1), in float32.
    A masked position gets ``-1e9`` added to its logits for every interest;
    in float32 that swamps the logits, so its weight is ``1/K`` for each
    interest, as in the reference.  The logit update sees ``caps``
    detached, the reference's stop-gradient: the gradient reaches ``S``
    and the history through the capsules, not through the routing
    logits."""
    b, t, d = history.shape
    u = history @ params["s"]                                        # (B, T, D)
    logits = torch.zeros((b, n_interests, t), dtype=torch.float32, device=history.device)
    neg = 0.0
    if mask is not None:
        neg = torch.where(mask, 0.0, -1e9).float()[:, None, :]
    caps = torch.zeros((b, n_interests, d), dtype=u.dtype, device=u.device)
    for _ in range(n_iters):
        w = torch.softmax(logits + neg, dim=1).to(u.dtype)           # over interests
        caps = _squash(torch.einsum("bkt,btd->bkd", w, u))
        logits = logits + torch.einsum("bkd,btd->bkt", caps.detach(), u).float()
    return caps
