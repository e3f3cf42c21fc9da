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
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._pytree import tree_flatten, tree_unflatten

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


def _chunks(offsets: torch.Tensor, max_edges: int,
            n_edges: int) -> list[tuple[int, int, int, int]]:
    """Chunks of whole segments, each at most ``max_edges`` edges long
    unless one segment alone is longer (one read of the offsets to the host).
    Fake offsets (the accounting's) have no values to read: the segments
    are cut into equal chunks whose edges are taken in proportion, so that
    the count sees as many gathers of as many bytes."""
    n = offsets.shape[0] - 1
    if is_fake(offsets):
        k = max(1, -(-n_edges // max_edges))
        bounds = [n * i // k for i in range(k + 1)]
        return [(lo, hi, n_edges * i // k, n_edges * (i + 1) // k)
                for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
    off = offsets.cpu().numpy()
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
    e = ei.shape[1]
    return _Edges(src, dst, dst_offsets, _chunks(dst_offsets, max_edges, e),
                  by_src, src_offsets, _chunks(src_offsets, max_edges, e), n_src, n_dst)


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
    """Full-batch: x (N, F), edge_index (2, E) → logits (N, C).  On
    DTensors see ``_forward_on_shards``."""
    if isinstance(x, DTensor):
        return _forward_on_shards(params, cfg, x, edge_index)
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
    innermost (largest) src set.  On DTensors see ``_blocks_on_shards``."""
    if isinstance(x_input, DTensor):
        return _blocks_on_shards(params, x_input, blocks)
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
    graph's, in the same order.  On DTensors split by graphs each rank runs
    its own graphs (the weights' gradients a partial sum over the split)."""
    if isinstance(x, DTensor):
        return _batched_on_shards(params, cfg, x, edge_index, node_mask)
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


# ------------------------------------------------------------- on DTensors
#
# The cells (``launch/steps.py``) split a graph's edges over the mesh's
# batch axes and its node rows the same way.  Each rank gathers the rows
# whole, sums its own edges over the whole node range in ``_EdgeSum``'s
# fixed order, and the ranks' partial sums are added row block by row block
# in rank order: an all-to-all brings every rank's partial of this rank's
# rows, and they are summed in order (``_sum_rows``).  The gradient of the
# gather is that ordered sum, the gradient of the sum that gather, so no
# sum over ranks takes an order the backend chooses.  Sharded against one
# device is then float32 TOL (the edges' terms are grouped by rank), and a
# second sharded run gives the same bits.


def _split_axes(t: DTensor, dim: int) -> list[int]:
    return [i for i, p in enumerate(t.placements) if p.is_shard(dim)]


def _on(mesh, axes: list[int], dim: int) -> list:
    return [Shard(dim) if i in axes else Replicate() for i in range(mesh.ndim)]


def _my_rows(n: int, mesh, axes: list[int]) -> tuple[int, int]:
    """[lo, hi) of the n rows this rank holds when they are split over
    ``axes`` in mesh order (DTensor's shards: ⌈size / m⌉ rows each, axis by
    axis)."""
    lo, size = 0, n
    for axis in axes:
        per = -(-size // mesh.size(axis))
        start = min(mesh.get_local_rank(axis) * per, size)
        lo, size = lo + start, min(per, size - start)
    return lo, lo + size


def _rows(t: torch.Tensor, mesh, axes: list[int], n: int) -> DTensor:
    """This rank's rows ``t`` as its shard of a DTensor of n rows split over
    ``axes``."""
    shape = (n,) + tuple(t.shape[1:])
    return DTensor.from_local(t, mesh, _on(mesh, axes, 0), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _gather(x: torch.Tensor, mesh, axes: list[int], n: int) -> torch.Tensor:
    """The n rows whole on every rank, from this rank's (rows, ...) ``x``."""
    return _rows(x, mesh, axes, n).redistribute(mesh, _on(mesh, [], 0)).to_local()


def _sum_rows(p: torch.Tensor, mesh, axes: list[int]) -> torch.Tensor:
    """This rank's rows of Σ_ranks p, p (n, ...) each rank's whole-range
    partial: the partials are stacked by rank, exchanged (all-to-all) so
    that each rank holds every rank's partial of its own rows, and added
    in rank order."""
    r = 1
    for axis in axes:
        r *= mesh.size(axis)
    st = _rows(p[None], mesh, axes, r).redistribute(mesh, _on(mesh, axes, 1)).to_local()
    out = st[0]
    for i in range(1, r):
        out = out + st[i]
    return out


class _GatherRows(torch.autograd.Function):
    """``_gather``; its gradient the ordered sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, n):
        ctx.mesh, ctx.axes = mesh, axes
        return _gather(x, mesh, axes, n)

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g.contiguous(), ctx.mesh, ctx.axes), None, None, None


class _SumRows(torch.autograd.Function):
    """``_sum_rows``; its gradient the rows' gradient gathered whole."""

    @staticmethod
    def forward(ctx, p, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, p.shape[0]
        return _sum_rows(p, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.n), None, None


def _local_edges(edge_index, axes: list[int]) -> torch.Tensor:
    if not isinstance(edge_index, DTensor) or _split_axes(edge_index, 1) != axes:
        raise ValueError("the edges must be a DTensor split over the axes that split the "
                         "node rows")
    return edge_index.to_local()


def _in_degrees(ei: torch.Tensor, n: int, mesh, axes: list[int]) -> torch.Tensor:
    """Every node's in-degree over all ranks' edges (whole counts in
    float32: exact in any order)."""
    return _gather(_sum_rows(_degrees(ei, n)[:, None], mesh, axes), mesh, axes, n)[:, 0]


def _forward_on_shards(params, cfg: GCNConfig, x: DTensor, edge_index) -> DTensor:
    """``forward`` with x's rows and the edges split over the same axes:
    each layer's aggregation as set out above, the linears on DTensors."""
    mesh, axes, n = x.device_mesh, _split_axes(x, 0), x.shape[0]
    ei = _local_edges(edge_index, axes)
    edges = _prepare(ei, n, n, max(x.shape[1], cfg.d_hidden))
    deg = _in_degrees(ei, n, mesh, axes) + 1.0                        # self-loop
    lo, hi = _my_rows(n, mesh, axes)
    if cfg.norm == "sym":
        r = torch.rsqrt(deg)
        w = r[edges.src] * r[edges.dst]
    else:                                                            # mean
        w = (1.0 / deg)[edges.dst]
    self_w = (1.0 / deg)[lo:hi, None]
    for i, lp in enumerate(params["layers"]):
        h = x.to_local()
        whole = _GatherRows.apply(h, mesh, axes, n)
        agg = _SumRows.apply(_EdgeSum.apply(whole, w.to(h.dtype), edges), mesh, axes)
        x = linear(lp, _rows(agg + h * self_w.to(h.dtype), mesh, axes, n))
        if i < len(params["layers"]) - 1:
            x = torch.relu(x)
    return x


def _blocks_on_shards(params, x: DTensor, blocks) -> DTensor:
    """``forward_blocks`` with x_input's rows and each block's edges split
    over the same axes; a block's destination rows come out split as its
    sources were."""
    mesh, axes = x.device_mesh, _split_axes(x, 0)
    for lp, (edge_index, n_src, n_dst) in zip(params["layers"], blocks):
        ei = _local_edges(edge_index, axes)
        edges = _prepare(ei, n_src, n_dst, x.shape[1])
        deg = _in_degrees(ei, n_dst, mesh, axes) + 1.0
        lo, hi = _my_rows(n_dst, mesh, axes)
        whole = _GatherRows.apply(x.to_local(), mesh, axes, n_src)
        ones = torch.ones(ei.shape[1], dtype=whole.dtype, device=whole.device)
        agg = _SumRows.apply(_EdgeSum.apply(whole, ones, edges), mesh, axes)
        h = _rows((agg + whole[lo:hi]) / deg[lo:hi, None].to(whole.dtype), mesh, axes, n_dst)
        x = torch.relu(linear(lp, h)) if lp is not params["layers"][-1] else linear(lp, h)
    return x


def _batched_on_shards(params, cfg: GCNConfig, x: DTensor, edge_index, node_mask) -> DTensor:
    """``forward_batched`` on each rank's graphs; the weights whole, their
    gradient a partial sum over the axes that split the graphs."""
    mesh = x.device_mesh
    axes = _split_axes(x, 0)
    pl = tuple(_on(mesh, axes, 0))
    grad = tuple(Partial() if i in axes else Replicate() for i in range(mesh.ndim))
    flat, spec = tree_flatten(params)
    rep = tuple(Replicate() for _ in pl)

    def local(x, edge_index, node_mask, *weights):
        return forward_batched(tree_unflatten(list(weights), spec), cfg, x, edge_index,
                               node_mask)

    return local_map(local, out_placements=list(pl),
                     in_placements=(pl, pl, pl) + (rep,) * len(flat),
                     in_grad_placements=(pl, pl, pl) + (grad,) * len(flat),
                     device_mesh=mesh, redistribute_inputs=True)(x, edge_index, node_mask,
                                                                 *flat)
