"""Optimizers, functional in the reference's form: ``init(params) → state``,
``update(grads, state, params) → (new_params, new_state)``.

``adagrad`` is the production choice for embedding tables (per-coordinate
rates tolerate the power-law update frequency of sparse rows); ``adamw`` for
dense towers; ``combined`` routes by parameter path, the standard recsys
split (DLRM trains exactly this way).

The updates run in place under ``torch.no_grad()``: the parameters and the
state handed in are the ones handed back, changed.  A caller that needs the
old values copies them first (``train.loop.train`` copies its initial
parameters).  Arithmetic follows the reference's order, but for adagrad's
step, ``p + (-lr)·g/d`` in one pass where the reference rounds ``lr·g``
first: the two differ in the last bit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import leaves_with_paths, tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    # update(grads, state, params) -> (new_params, new_state)


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _device(tree: PyTree) -> torch.device | None:
    """The device of the tree's first leaf (None for an empty tree)."""
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


def sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return tree_map(torch.zeros_like, params)
        return ()

    @torch.no_grad()
    def update(grads, state, params):
        if momentum:
            tree_map(lambda m, g: m.mul_(momentum).add_(g), state, grads)
            step = state
        else:
            step = grads
        tree_map(lambda p, s: p.sub_(s.to(p.dtype) * lr), params, step)
        return params, state

    return Optimizer(init, update)


def adagrad(lr: float = 0.01, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return tree_map(_zeros32, params)

    @torch.no_grad()
    def update(grads, state, params):
        def one(p, g, s):
            g = g.float()
            s.addcmul_(g, g)
            p.addcdiv_(g, s.sqrt().add_(eps), value=-lr)

        tree_map(one, params, grads, state)
        return params, state

    return Optimizer(init, update)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros32, params), "nu": tree_map(_zeros32, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params):
        # the bias corrections in float32 on the parameters' device, as the
        # reference computes them on its own: no read to the host, so a step
        # neither synchronises nor stops a trace on fake tensors.  The count
        # lives there from ``init`` on (a count kept elsewhere is moved),
        # so every path divides by a tensor of that device alike: a 0-d
        # host tensor would make the division a multiplication by its
        # reciprocal on the card, which rounds otherwise
        dev = _device(params)
        count = (state["count"] if dev is None else state["count"].to(dev)) + 1
        n = count.float()
        c1 = 1 - b1 ** n
        c2 = 1 - b2 ** n

        def one(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p.float(), alpha=weight_decay)
            p.sub_(upd.mul_(lr).to(p.dtype))

        tree_map(one, params, grads, state["mu"], state["nu"])
        return params, {"mu": state["mu"], "nu": state["nu"], "count": count}

    return Optimizer(init, update)


def combined(route: Callable[[str], bool], sparse_opt: Optimizer,
             dense_opt: Optimizer) -> Optimizer:
    """Route each leaf, by its path, to ``sparse_opt`` (True) or ``dense_opt``.

    Typical: ``route = lambda path: 'table' in str(path)``; ``path`` is the
    leaf's ``keystr`` string, so the reference's route functions work as
    they are.  The reference updates every leaf with both optimisers and
    keeps one result; here each optimiser keeps state for, and updates, only
    the leaves it owns, which gives the same parameters.  On DLRM-RMC2 that
    is the difference between 5.12 GB of adagrad state and 5.12 GB of
    adagrad state plus 10.24 GB of AdamW moments that no table reads.  Each
    side's state is a dictionary from path to leaf.
    """
    def side(tree, sparse: bool) -> dict:
        return {k: v for k, v in leaves_with_paths(tree) if bool(route(k)) == sparse}

    def init(params):
        return {"sparse": sparse_opt.init(side(params, True)),
                "dense": dense_opt.init(side(params, False))}

    def update(grads, state, params):
        ps, ss = sparse_opt.update(side(grads, True), state["sparse"], side(params, True))
        pd, sd = dense_opt.update(side(grads, False), state["dense"], side(params, False))
        new = {**ps, **pd}
        return (tree_map(lambda path, _: new[path], params, with_path=True),
                {"sparse": ss, "dense": sd})

    return Optimizer(init, update)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The float32 2-norm of every leaf together, on the leaves' device."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in tree_leaves(tree)]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``, in place;
    returns ``grads``."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
    tree_map(lambda g: g.mul_(scale.to(g.dtype)), grads)
    return grads
