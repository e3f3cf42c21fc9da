"""Loss and gradients of a parameter tree, whole or accumulated over
microbatches (a Python loop where the reference scans)."""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.utils import leaves_with_paths, tree_map

PyTree = Any


def value_and_grad(loss_fn: Callable, params: PyTree, batch: PyTree):
    """(loss, grads) of ``loss_fn(params, batch)``; grads share params'
    structure (zeros for a leaf the loss does not reach).  Every leaf must be
    a floating tensor.  The loss sees aliases of the leaves (``detach`` shares
    their storage), so nothing is copied and the caller's tensors keep their
    ``requires_grad``.

    A DTensor leaf's gradient is put at its parameter's split on every mesh
    axis that splits the parameter as soon as autograd has summed it, inside
    the backward (a hook on the alias, ``sharding.grad_placements``): a
    weight gradient that an operation's rule leaves whole on every rank, a
    partial sum over ``model``, is reduce-scattered to the rank's shard
    and freed, never held whole until the backward ends.  Over the batch
    axes it stays a partial sum; ``launch/steps.py::_settle`` adds those up
    once a step.  A gradient already at the parameter's split (the tables'
    and the expert stacks', which ``kernels/ops.py`` and
    ``layers/moe.py::make_sharded_moe`` place) is handed over as it is."""
    def alias(p):
        if not (isinstance(p, torch.Tensor) and p.is_floating_point()):
            raise TypeError(f"every parameter leaf must be a floating tensor, got {type(p)}")
        a = p.detach().requires_grad_(True)
        if isinstance(a, DTensor):
            a.register_hook(lambda g, pl=a.placements: _at_param_split(g, pl))
        return a

    aliases = tree_map(alias, params)
    with torch.enable_grad():
        loss = loss_fn(aliases, batch)
    paths, xs = zip(*leaves_with_paths(aliases))
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    by_path = {k: torch.zeros_like(x) if g is None else g for k, x, g in zip(paths, xs, gs)}
    return loss.detach(), tree_map(lambda k, _: by_path[k], aliases, with_path=True)


def _at_param_split(g: DTensor, param_placements) -> DTensor:
    return shd.redistribute_in_order(g, shd.grad_placements(g.placements, param_placements))


def _zeros_f32_like(g: torch.Tensor) -> torch.Tensor:
    """A float32 accumulator of ``g``'s shape; a DTensor's at ``g``'s own
    placements (a partial sum over the batch axes stays one: zeros are a
    partial sum of zeros)."""
    if not isinstance(g, DTensor):
        return torch.zeros_like(g, dtype=torch.float32)
    return DTensor.from_local(torch.zeros_like(g.to_local(), dtype=torch.float32),
                              g.device_mesh, g.placements, run_check=False,
                              shape=g.shape, stride=g.stride())


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


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
    share a microbatch is not).  A DTensor gradient is accumulated on each
    rank's local tensor at the placements ``value_and_grad`` hands over:
    a partial sum over the batch axes stays one, so no microbatch's
    gradient is reduced across ranks here.
    """
    if num_microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)

    def chunk(x, i):
        local = _local(x)
        b = local.shape[0]
        if b % num_microbatches:
            raise ValueError(f"a batch of {b} does not split into {num_microbatches} microbatches")
        part = local.reshape(num_microbatches, b // num_microbatches, *local.shape[1:])[i]
        if isinstance(x, DTensor):
            return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False)
        return part

    def add(acc, g):
        if isinstance(g, DTensor) and g.placements != acc.placements:
            raise ValueError(f"a gradient placed {g.placements} after one placed "
                             f"{acc.placements}")
        _local(acc).add_(_local(g).float())

    loss_sum = grad_sum = None
    for i in range(num_microbatches):
        loss, grads = value_and_grad(loss_fn, params, tree_map(lambda x: chunk(x, i), batch))
        loss_sum = loss.float() if loss_sum is None else loss_sum + loss.float()
        if grad_sum is None:
            grad_sum = tree_map(_zeros_f32_like, grads)
        tree_map(add, grad_sum, grads)
    inv = 1.0 / num_microbatches
    tree_map(lambda g: _local(g).mul_(inv), grad_sum)
    return loss_sum * inv, grad_sum
