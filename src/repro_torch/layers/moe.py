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

``make_sharded_moe`` is the expert-parallel layer over a ``DeviceMesh``
with a ``model`` axis: each model rank keeps E/m experts, dispatches its
own tokens, and one all-reduce over the model group combines the outputs.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

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


def _route(router, xt: torch.Tensor, top_k: int):
    """(probs (T, E) float32, renormalised top-k weights, top-k experts)."""
    logits = linear(router, xt).float()                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)                    # (T, K)
    return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def _experts(xt: torch.Tensor, stok, sw, keep, slot, n_experts: int, cap: int,
             wg, wu, wd) -> torch.Tensor:
    """The kept assignments through their experts' SwiGLU in a dense
    (E, C, d) buffer, each token's outputs summed by weight: (T, d)."""
    t, d = xt.shape
    buf = xt.new_zeros((n_experts * cap + 1, d)).index_put((slot,), xt[stok])
    xin = buf[:-1].reshape(n_experts, cap, d)                        # (E, C, d)
    g = F.silu(torch.matmul(xin, wg))
    u = torch.matmul(xin, wu)
    eo = torch.matmul(g * u, wd)                                     # (E, C, d)
    yflat = torch.cat([eo.reshape(n_experts * cap, d), eo.new_zeros((1, d))])
    contrib = yflat[slot] * (sw * keep).to(eo.dtype)[:, None]
    return eo.new_zeros((t, d)).index_add_(0, stok, contrib)


def _aux_loss(probs: torch.Tensor, topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch's load-balance loss E · Σ_e f_e · p_e.  Expert loads count as
    the reference's .at[].add(1.0): exact in float32, and no host round trip
    (bincount reads its input's max), so a decode step can be captured as a
    CUDA graph."""
    n = topi.numel()
    frac = probs.new_zeros(n_experts).index_add_(0, topi.reshape(-1), probs.new_ones(n)) / n
    return n_experts * (frac * probs.mean(dim=0)).sum()


def apply_moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, d) → (y (B, S, d), {"aux_loss", "dropped_frac"}): the
    Switch load-balance loss E·Σ_e f_e·p_e and the share of the T·k
    assignments dropped at capacity, both float32 scalars.  ``n_experts``
    comes from the expert weight stack."""
    n_experts = params["wg"].shape[0]
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, topw, topi = _route(params["router"], xt, top_k)

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

    y = _experts(xt, stok, sw, keep, slot, n_experts, cap, params["wg"], params["wu"],
                 params["wd"])
    y = y.to(x.dtype).reshape(b, s, d)
    dropped = 1.0 - keep.sum().float() / (t * top_k)
    return y, {"aux_loss": _aux_loss(probs, topi, n_experts), "dropped_frac": dropped}


def make_sharded_moe(mesh, *, top_k: int, capacity_factor: float = 1.25):
    """Production MoE across ranks: local dispatch + expert parallelism.

    Activations are batch-sharded over the mesh's other axes and replicated
    over ``model``.  Each model rank routes its LOCAL tokens, keeps only ITS
    slice of E/m experts, runs the sort-based dispatch locally (capacity ∝
    local tokens), and one all-reduce (SUM) over the ``model`` group
    combines the expert outputs: the only collective on y.

    Returns ``moe_fn(layer_params, x (B, S, d)) → (y, {"aux_loss",
    "dropped_frac"})``, x and y this rank's batch shard.  The expert stacks
    wg/wu/wd are DTensors sharded over ``model`` on dim 0 (the LM sharding
    rules' ``("model", None, None)``) or plain tensors of this rank's slice;
    the router is whole (replicated).  ``aux_loss`` is the mean over every
    rank; ``dropped_frac`` is the mean over the ranks outside the model
    group, taken as the mean over every rank: the model ranks of one batch
    shard hold the same value, since their kept counts are summed first.
    """
    group = mesh.get_group("model")
    m = dist.get_world_size(group)
    rank = mesh.get_local_rank("model")
    world = dist.get_world_size()

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    def moe_fn(layer_params, x: torch.Tensor):
        wg, wu, wd = (local(layer_params[k]) for k in ("wg", "wu", "wd"))
        router = {k: local(v) for k, v in layer_params["router"].items()}
        e_local = wg.shape[0]                         # E/m experts on this rank
        n_experts = e_local * m
        b, s, d = x.shape
        t = b * s
        xt = x.reshape(t, d)
        dev = x.device
        probs, topw, topi = _route(router, xt, top_k)

        cap = moe_capacity(t, n_experts, top_k, capacity_factor)
        e_flat = topi.T.reshape(-1)
        tok_flat = torch.arange(t, device=dev).repeat(top_k)
        w_flat = topw.T.reshape(-1)
        # keep only this rank's expert slice; the others sort past it
        lo = rank * e_local
        mine = (e_flat >= lo) & (e_flat < lo + e_local)
        e_loc = torch.where(mine, e_flat - lo, torch.full_like(e_flat, e_local))
        order = torch.argsort(e_loc, stable=True)
        se, stok, sw = e_loc[order], tok_flat[order], w_flat[order]
        start = torch.searchsorted(se, torch.arange(e_local, device=dev))
        start = torch.cat([start, start.new_zeros(1)])  # the overflow bin is never kept
        rank_in_e = torch.arange(t * top_k, device=dev) - start[se]
        keep = (se < e_local) & (rank_in_e < cap)
        slot = torch.where(keep, se * cap + rank_in_e, torch.full_like(se, e_local * cap))

        y = _experts(xt, stok, sw, keep, slot, e_local, cap, wg, wu, wd).to(x.dtype)
        # combine the expert slices (a token's experts live across model ranks)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)

        kept = keep.sum().float()
        dist.all_reduce(kept, op=dist.ReduceOp.SUM, group=group)
        stats = torch.stack([_aux_loss(probs, topi, n_experts), 1.0 - kept / (t * top_k)])
        dist.all_reduce(stats, op=dist.ReduceOp.SUM)
        stats = stats / world
        return y.reshape(b, s, d), {"aux_loss": stats[0], "dropped_frac": stats[1]}

    return moe_fn
