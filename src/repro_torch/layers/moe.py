"""Top-k routed Mixture-of-Experts with the JAX package's sort-based
capacity dispatch.

Expert weights carry a leading E axis.  A call routes its T tokens: the
router's logits in float32, a softmax over the experts, the top-k kept
and renormalised.  The T·k assignments are flattened k-major (every
token's first choice before any second choice), sorted by expert with a
**stable** sort, and ranked within their expert; an assignment ranked at
or past the capacity C drops.  The kept ones are copied into a dense
(E·C + 1, d) buffer whose last row takes every dropped one, the three
expert products run as batched matrix products over (E, C, d), and each
token sums its kept assignments' outputs, weighted, with ``index_add_``
(the reference's ``segment_sum``).  The residual outside the layer
carries a dropped token through.

Two properties of the reference are kept as they are, not fixed:

* **Capacity at decode.**  C = max(int(T·k·capacity_factor / E), 1)
  depends on the tokens of the call.  A decode step routes only its B
  tokens, so at B = 8 qwen3-moe-30b-a3b (128 experts, top-8) has C = 1
  and granite-moe-1b-a400m (32 experts) C = 2: many assignments drop.
* **Prefill then decode differs from a forward** for an MoE model, since
  the capacity of a call of S tokens is not that of a call of one.

On a CUDA tensor ``index_add_`` adds with atomics, so the order in which
a token's k terms are summed is not fixed from one run to the next.

``make_sharded_moe`` (the reference's ``shard_map`` expert-parallel
variant) is not ported: it belongs with the distributed tools.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.mlp import init_linear, linear


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, *, dtype: torch.dtype = torch.float32,
             device: torch.device | str) -> dict:
    """Router (d_model, E) without bias; SwiGLU experts wg, wu (E, d_model,
    d_ff) and wd (E, d_ff, d_model), the reference's scales.  ``top_k`` is
    not stored: it is the caller's, as in the reference."""
    scale = (1.0 / d_model) ** 0.5

    def normal(shape, s):
        return (torch.randn(shape, generator=generator, device=device) * s).to(dtype)

    return {
        "router": init_linear(generator, d_model, n_experts, bias=False, dtype=dtype,
                              device=device),
        "wg": normal((n_experts, d_model, d_ff), scale),
        "wu": normal((n_experts, d_model, d_ff), scale),
        "wd": normal((n_experts, d_ff, d_model), (1.0 / d_ff) ** 0.5),
    }


def moe_capacity(num_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert for a call of ``num_tokens`` tokens, at least 1."""
    return max(int(num_tokens * top_k * capacity_factor / n_experts), 1)


def apply_moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, d) → (y (B, S, d), {"aux_loss", "dropped_frac"}): the
    Switch load-balance loss E·Σ_e f_e·p_e and the share of the T·k
    assignments dropped at capacity, both float32 scalars.  ``n_experts``
    comes from the expert weight stack."""
    n_experts = params["wg"].shape[0]
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)

    logits = linear(params["router"], xt).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)                    # (T, K)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)        # renormalise

    cap = moe_capacity(t, n_experts, top_k, capacity_factor)
    # flatten K-major so that k = 0 (the highest router weight) sorts first
    # within each expert
    e_flat = topi.T.reshape(-1)                                      # (K·T,)
    tok_flat = torch.arange(t, device=x.device).repeat(top_k)
    w_flat = topw.T.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se, stok, sw = e_flat[order], tok_flat[order], w_flat[order]
    start = torch.searchsorted(se, torch.arange(n_experts, device=x.device))
    rank = torch.arange(t * top_k, device=x.device) - start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, torch.full_like(se, n_experts * cap))

    buf = xt.new_zeros((n_experts * cap + 1, d)).index_put((slot,), xt[stok])
    xin = buf[:-1].reshape(n_experts, cap, d)                        # (E, C, d)
    g = F.silu(torch.matmul(xin, params["wg"]))
    u = torch.matmul(xin, params["wu"])
    eo = torch.matmul(g * u, params["wd"])                           # (E, C, d)
    yflat = torch.cat([eo.reshape(n_experts * cap, d), eo.new_zeros((1, d))])
    contrib = yflat[slot] * (sw * keep).to(eo.dtype)[:, None]
    y = eo.new_zeros((t, d)).index_add_(0, stok, contrib)
    y = y.to(x.dtype).reshape(b, s, d)

    # load-balance auxiliary loss (Switch): E · Σ_e f_e · p_e
    # counts as the reference's .at[].add(1.0): exact in float32, and no
    # host round trip (bincount reads its input's max), so a decode step
    # can be captured as a CUDA graph
    frac = probs.new_zeros(n_experts).index_add_(
        0, topi.reshape(-1), probs.new_ones(t * top_k)) / (t * top_k)
    aux = n_experts * (frac * probs.mean(dim=0)).sum()
    dropped = 1.0 - keep.sum().float() / (t * top_k)
    return y, {"aux_loss": aux, "dropped_frac": dropped}
