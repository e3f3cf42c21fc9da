"""Collectives with compute/communication overlap, on a ``torch.distributed``
process group.

``overlapped_all_gather_matmul`` is the TP-MLP hot path.  Instead of
all-gather(x) → x@W, which finishes the transfer before the matrix product
starts, the ring variant passes one shard a step to the next rank and
multiplies the shard it holds while the next one is in flight (the
reference does the same with ``ppermute`` under ``shard_map``).

Each function takes a process group (``None``: the default one) and works
with this process's rank in it.  A ring of one rank makes no P2P call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_shift(send: torch.Tensor, group):
    """Start passing ``send`` to the next rank and receiving the previous
    rank's tensor of the same shape: (receive buffer, works to wait on)."""
    n, r = _size_rank(group)
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, _global(group, (r + 1) % n), group),
        dist.P2POp(dist.irecv, recv, _global(group, (r - 1) % n), group)])
    return recv, works


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather along dim 0 as an (n - 1)-step ring of sends and receives
    (the building block of the overlap; equal to a tiled all-gather)."""
    n, r = _size_rank(group)
    chunks = [None] * n
    chunks[r] = cur = x.contiguous()
    for step in range(1, n):
        cur, works = ring_shift(cur, group)
        for w in works:
            w.wait()
        chunks[(r - step) % n] = cur               # it started at rank r - step
    return torch.cat(chunks, dim=0)


def overlapped_all_gather_matmul(x_shard: torch.Tensor, w: torch.Tensor,
                                 group=None) -> torch.Tensor:
    """all_gather(x, dim 0) @ w with ring overlap.

    x_shard (Bs, K) is this rank's batch shard; w (K, N) is resident.
    Returns the full (B, N) product (B = Bs × ranks).  Each step starts
    sending the shard it holds to the next rank, multiplies it, then waits
    for the previous rank's shard: the transfer hides under the product."""
    n, r = _size_rank(group)
    bs = x_shard.shape[0]
    out = x_shard.new_empty((bs * n, w.shape[1]))
    cur, src = x_shard.contiguous(), r
    for step in range(n):
        pending = ring_shift(cur, group) if step < n - 1 else None
        torch.matmul(cur, w, out=out[src * bs:(src + 1) * bs])
        if pending is not None:
            cur, works = pending
            for wk in works:
                wk.wait()
        src = (src - 1) % n
    return out


def reduce_scatter_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Row-parallel matmul: x (B, Ks) @ w_shard (Ks, N), summed over the
    group and scattered over the batch: rank r gets rows [r·B/n, (r+1)·B/n).
    The row-sharded half of the Megatron pair."""
    n, _ = _size_rank(group)
    y = x @ w_shard
    out = y.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
    dist.reduce_scatter_tensor(out, y.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out
