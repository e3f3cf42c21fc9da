"""GCN (Kipf & Welling) with sparse message passing, in the JAX package's
formulation: gather the source features, scale them by the normalisation
1/√(dᵢdⱼ) (or 1/dⱼ), and sum them into their destinations.

Supports the four GNN shapes:
  * full-batch (Cora, ogbn-products scale)     — ``forward``
  * sampled minibatch with a real fanout sampler — ``sample_neighbors`` (host,
    numpy) + ``forward_blocks``
  * batched small graphs (molecule)             — ``forward_batched`` with
    per-graph masking + mean readout

**The reduction.** The reference sums with ``jax.ops.segment_sum``.  The
obvious torch twin, ``index_add_``, sums a CUDA float32 tensor with atomics,
so its order changes from run to run.  Here every sum over edges runs in a
fixed order, so a training step repeats to the bit:

* the edges are sorted by destination with a stable sort, so each
  destination's messages keep their order in ``edge_index`` (the order in
  which the reference adds them);
* ``torch.segment_reduce`` over the CSR offsets sums each destination's
  run: on CUDA one thread per (destination, feature), looping over the run
  in order;
* the gradient with respect to ``x`` is the same sum over the edges sorted
  by source (``_EdgeSum.backward``), never an atomic scatter.

The messages are gathered a chunk of whole destinations at a time, at most
``MAX_CHUNK_ELEMENTS`` of them, so the (E, F) message tensor of a large
graph (24.7 GB at ogbn-products' first layer) is never held whole; a
destination never spans two chunks, so the order of its sum is unchanged.

Kept as the reference has them: the self-loop weight is 1/deg for both
norms; ``forward_blocks`` picks the last layer by identity
(``lp is not params["layers"][-1]``); degrees are counted in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.layers.mlp import init_linear, linear

# elements of gathered messages a chunk holds: 1 GiB of float32
MAX_CHUNK_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int
    d_feat: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"            # mean == sym-normalized for GCN
    norm: str = "sym"
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init(generator: torch.Generator, cfg: GCNConfig, *,
         device: torch.device | str | None = None):
    """One linear layer (``w`` (d_in, d_out), ``b``) per GCN layer, on
    ``device`` (the GPU unless the caller passes one)."""
    device = resolve(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": [init_linear(generator, dims[i], dims[i + 1], dtype=cfg.tdtype,
                                   device=device)
                       for i in range(cfg.n_layers)]}


def _degrees(edge_index: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """In-degree of every node of a (2, E) edge tensor, counted in float32
    (exact below 2^24, so the order of the adds does not matter)."""
    dst = edge_index[1].long()
    return torch.zeros(n_nodes, dtype=torch.float32, device=dst.device).index_add_(
        0, dst, torch.ones(dst.shape[0], dtype=torch.float32, device=dst.device))


@dataclasses.dataclass(frozen=True)
class _Edges:
    """An edge list laid out for fixed-order sums: sorted by destination
    (stable), with CSR offsets by destination and, for the gradient, the
    permutation that sorts it by source and the offsets by source.  A
    chunk is (first node, end node, first edge, end edge)."""
    src: torch.Tensor                   # (E,) int64, in destination order
    dst: torch.Tensor                   # (E,) int64, sorted
    dst_offsets: torch.Tensor           # (n_dst + 1,)
    dst_chunks: list[tuple[int, int, int, int]]
    by_src: torch.Tensor                # (E,) sorts src stably
    src_offsets: torch.Tensor           # (n_src + 1,)
    src_chunks: list[tuple[int, int, int, int]]
    n_src: int
    n_dst: int


def _chunks(offsets: torch.Tensor, max_edges: int) -> list[tuple[int, int, int, int]]:
    """Chunks of whole segments, each at most ``max_edges`` edges long
    unless one segment alone is longer (one read of the offsets to the host)."""
    off = offsets.cpu().numpy()
    n = len(off) - 1
    out, lo = [], 0
    while lo < n or not out:
        hi = int(np.searchsorted(off, off[lo] + max_edges, side="right")) - 1
        hi = min(max(hi, lo + 1), n)
        out.append((lo, hi, int(off[lo]), int(off[hi])))
        lo = hi
    return out


def _prepare(edge_index: torch.Tensor, n_src: int, n_dst: int, width: int) -> _Edges:
    ei, device = edge_index.long(), edge_index.device
    order = torch.argsort(ei[1], stable=True)
    src, dst = ei[0][order], ei[1][order]
    by_src = torch.argsort(src, stable=True)
    dst_offsets = torch.searchsorted(dst, torch.arange(n_dst + 1, device=device))
    src_offsets = torch.searchsorted(src[by_src], torch.arange(n_src + 1, device=device))
    max_edges = max(MAX_CHUNK_ELEMENTS // max(width, 1), 1)
    return _Edges(src, dst, dst_offsets, _chunks(dst_offsets, max_edges),
                  by_src, src_offsets, _chunks(src_offsets, max_edges), n_src, n_dst)


def _segment_sum(values: torch.Tensor, index: torch.Tensor, weight: torch.Tensor,
                 offsets: torch.Tensor, chunks, n_out: int) -> torch.Tensor:
    """out[i] = Σ_{e in segment i} weight[e]·values[index[e]], every
    segment summed in order; a chunk of segments at a time."""
    out = values.new_empty((n_out, values.shape[1]))
    for lo, hi, e0, e1 in chunks:
        msgs = values.index_select(0, index[e0:e1]).mul_(weight[e0:e1, None])
        out[lo:hi] = torch.segment_reduce(msgs, "sum", offsets=offsets[lo:hi + 1] - e0,
                                          axis=0)
    return out


class _EdgeSum(torch.autograd.Function):
    """out[d] = Σ_{edges s→d} w_e·x[s] in edge order; the gradient with
    respect to x the transposed sum, by source, also in a fixed order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, edges: _Edges) -> torch.Tensor:
        ctx.edges = edges
        ctx.save_for_backward(w)
        return _segment_sum(x, edges.src, w, edges.dst_offsets, edges.dst_chunks, edges.n_dst)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        e = ctx.edges
        (w,) = ctx.saved_tensors
        grad = _segment_sum(g.contiguous(), e.dst[e.by_src], w[e.by_src], e.src_offsets,
                            e.src_chunks, e.n_src)
        return grad, None, None


def _aggregate(x: torch.Tensor, edges: _Edges, deg: torch.Tensor, norm: str) -> torch.Tensor:
    """One Ã·X aggregation over prepared edges; ``deg`` includes the self-loop."""
    if norm == "sym":
        r = torch.rsqrt(deg)
        w = r[edges.src] * r[edges.dst]
    else:                                                            # mean
        w = (1.0 / deg)[edges.dst]
    agg = _EdgeSum.apply(x, w.to(x.dtype), edges)
    self_w = (1.0 / deg)[:, None].to(x.dtype)                        # 1/deg for both norms
    return agg + x * self_w                                          # self-loop term


def gcn_aggregate(x: torch.Tensor, edge_index, n_nodes: int, *,
                  norm: str = "sym") -> torch.Tensor:
    """One Ã·X aggregation (with self-loops folded in via the +x term)."""
    ei = torch.as_tensor(edge_index, device=x.device)
    edges = _prepare(ei, n_nodes, n_nodes, x.shape[1])
    return _aggregate(x, edges, _degrees(ei, n_nodes) + 1.0, norm)


def forward(params, cfg: GCNConfig, x: torch.Tensor, edge_index) -> torch.Tensor:
    """Full-batch: x (N, F), edge_index (2, E) → logits (N, C)."""
    n = x.shape[0]
    ei = torch.as_tensor(edge_index, device=x.device)
    edges = _prepare(ei, n, n, max(x.shape[1], cfg.d_hidden))
    deg = _degrees(ei, n) + 1.0                                      # self-loop
    for i, lp in enumerate(params["layers"]):
        x = _aggregate(x, edges, deg, cfg.norm)
        x = linear(lp, x)
        if i < len(params["layers"]) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params, cfg: GCNConfig, batch: dict) -> torch.Tensor:
    logits = forward(params, cfg, batch["x"], batch["edge_index"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    mask = batch.get("train_mask")
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()


# ------------------------------------------------------------- minibatch


def sample_neighbors(indptr: np.ndarray, indices: np.ndarray,
                     seeds: np.ndarray, fanouts: Sequence[int],
                     rng: np.random.Generator):
    """Real layered neighbor sampler (GraphSAGE-style), host-side numpy,
    the reference's line for line, so one generator gives both packages the
    same blocks.

    CSR graph (indptr, indices); returns per-layer blocks outer→inner:
    [(edge_index_l, n_src_l, n_dst_l)] and the final input node ids.  Block l
    edges are (src_local, dst_local) with dst = the layer's seed nodes
    (prefix of the src id space, standard DGL block layout).
    """
    blocks = []
    cur = np.asarray(seeds, np.int64)
    for fanout in fanouts:
        uniq = cur
        srcs, dsts = [], []
        for li, node in enumerate(uniq):
            lo, hi = indptr[node], indptr[node + 1]
            nbrs = indices[lo:hi]
            if len(nbrs) > fanout:
                nbrs = rng.choice(nbrs, size=fanout, replace=False)
            srcs.append(nbrs)
            dsts.append(np.full(len(nbrs), li, np.int64))
        flat_src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
        flat_dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
        # local id space: dst seeds occupy [0, len(uniq)); new srcs appended
        # so that the seeds stay a prefix
        order = {n: i for i, n in enumerate(uniq)}
        nxt = len(uniq)
        src_local = np.empty_like(flat_src)
        for i, s in enumerate(flat_src):
            if s not in order:
                order[s] = nxt
                nxt += 1
            src_local[i] = order[s]
        n_src = nxt
        edge_index = np.stack([src_local, flat_dst])
        blocks.append((edge_index, n_src, len(uniq)))
        # next layer's seeds = this layer's full src set
        inv_nodes = np.empty(nxt, np.int64)
        for node, loc in order.items():
            inv_nodes[loc] = node
        cur = inv_nodes
    return blocks[::-1], cur            # inner-first blocks, input node ids


def forward_blocks(params, cfg: GCNConfig, x_input: torch.Tensor, blocks) -> torch.Tensor:
    """Run GCN over sampled blocks.  blocks inner-first; x_input covers the
    innermost (largest) src set."""
    x = x_input
    for lp, (edge_index, n_src, n_dst) in zip(params["layers"], blocks):
        ei = torch.as_tensor(edge_index, device=x.device)
        edges = _prepare(ei, n_src, n_dst, x.shape[1])
        deg = _degrees(ei, n_dst) + 1.0
        ones = torch.ones(ei.shape[1], dtype=x.dtype, device=x.device)
        agg = _EdgeSum.apply(x, ones, edges)
        h = (agg + x[:n_dst]) / deg[:, None].to(x.dtype)
        x = torch.relu(linear(lp, h)) if lp is not params["layers"][-1] else linear(lp, h)
    return x


# --------------------------------------------------------- batched graphs


def forward_batched(params, cfg: GCNConfig, x: torch.Tensor, edge_index: torch.Tensor,
                    node_mask: torch.Tensor) -> torch.Tensor:
    """Molecule regime: x (G, N, F), edge_index (G, 2, E), node_mask (G, N)
    → graph logits (G, C) via masked mean readout.

    The reference maps ``forward`` over the graphs (``jax.vmap``); here the
    G graphs are one graph of G·N nodes, graph g's node ids offset by g·N.
    No edge joins two graphs, so every node's degree and sum are its own
    graph's, in the same order."""
    g, n, f = x.shape
    offset = (torch.arange(g, device=x.device) * n)[:, None, None]
    flat_ei = (edge_index.long() + offset).permute(1, 0, 2).reshape(2, -1)
    h = forward(params, cfg, x.reshape(g * n, f), flat_ei).reshape(g, n, -1)
    m = node_mask.to(h.dtype)[:, :, None]
    return (h * m).sum(1) / m.sum(1).clamp_min(1.0)


def graph_loss_fn(params, cfg: GCNConfig, batch: dict) -> torch.Tensor:
    logits = forward_batched(params, cfg, batch["x"], batch["edge_index"],
                             batch["node_mask"]).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None]).mean()
