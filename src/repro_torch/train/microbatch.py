"""Loss and gradients of a parameter tree, whole or accumulated over
microbatches (a Python loop where the reference scans)."""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.utils import leaves_with_paths, tree_map

PyTree = Any


def value_and_grad(loss_fn: Callable, params: PyTree, batch: PyTree):
    """(loss, grads) of ``loss_fn(params, batch)``; grads share params'
    structure (zeros for a leaf the loss does not reach).  Every leaf must be
    a floating tensor.  The loss sees aliases of the leaves (``detach`` shares
    their storage), so nothing is copied and the caller's tensors keep their
    ``requires_grad``."""
    def alias(p):
        if not (isinstance(p, torch.Tensor) and p.is_floating_point()):
            raise TypeError(f"every parameter leaf must be a floating tensor, got {type(p)}")
        return p.detach().requires_grad_(True)

    aliases = tree_map(alias, params)
    with torch.enable_grad():
        loss = loss_fn(aliases, batch)
    paths, xs = zip(*leaves_with_paths(aliases))
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    by_path = {k: torch.zeros_like(x) if g is None else g for k, x, g in zip(paths, xs, gs)}
    return loss.detach(), tree_map(lambda k, _: by_path[k], aliases, with_path=True)


def accumulated_grads(loss_fn: Callable, params: PyTree, batch: PyTree,
                      num_microbatches: int):
    """Split the batch's leading dimension into ``num_microbatches`` chunks,
    take each one's loss and gradients in turn, and return (mean loss, mean
    grads), accumulated in float32.  With one microbatch: the whole batch's
    loss and gradients, in the parameters' dtype.

    Peak activation memory drops by about ``num_microbatches``, at the cost
    of as many passes: the standard lever when memory is the limit.  A
    DTensor leaf split over its batch is split on each rank: microbatch i
    is every rank's i-th chunk of its own shard, so no rank waits on rows
    another holds (the mean over microbatches is the same; which rows
    share a microbatch is not).
    """
    if num_microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)

    def chunk(x, i):
        local = x.to_local() if isinstance(x, DTensor) else x
        b = local.shape[0]
        if b % num_microbatches:
            raise ValueError(f"a batch of {b} does not split into {num_microbatches} microbatches")
        part = local.reshape(num_microbatches, b // num_microbatches, *local.shape[1:])[i]
        if isinstance(x, DTensor):
            return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
        return part

    loss_sum = None
    grad_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for i in range(num_microbatches):
        loss, grads = value_and_grad(loss_fn, params, tree_map(lambda x: chunk(x, i), batch))
        loss_sum = loss.float() if loss_sum is None else loss_sum + loss.float()
        tree_map(lambda a, g: a.add_(g.float()), grad_sum, grads)
    inv = 1.0 / num_microbatches
    return loss_sum * inv, tree_map(lambda g: g.mul_(inv), grad_sum)
