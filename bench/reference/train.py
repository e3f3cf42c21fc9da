"""A plain PyTorch training step of the benchmark's models: binary
cross-entropy with logits averaged over the batch, its gradients by
autograd over ``recsys.logits`` block by block, the gradients' global
2-norm clipped, then Adagrad on the embedding tables and Adam (no weight
decay) on every other leaf, with their textbook updates:

    Adagrad   s += g²;  p -= lr · g / (√s + ε)
    Adam      m = β₁m + (1-β₁)g;  v = β₂v + (1-β₂)g²;
              p -= lr · (m / (1-β₁ᵗ)) / (√(v / (1-β₂ᵗ)) + ε)

The optimiser state keeps the layout the benchmark reads a first gradient
from: ``{"sparse": {path: s}, "dense": {"mu": {path: m}, "nu": {path: v},
"count": t}}``, so that this step can stand in the program's place (the
control).
"""
from __future__ import annotations

import torch

from bench.reference import recsys

# a leaf whose path holds this name is an embedding table, Adagrad's; every
# other leaf is Adam's (the port's ``launch/train.py`` routes them alike)
SPARSE_KEY = "table"


def _leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _leaves(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, new: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return new[prefix]


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy with logits."""
    return (torch.clamp(logit, min=0) - logit * label
            + torch.log1p(torch.exp(-logit.abs())))


def loss_and_grads(params: dict, model: dict, batch: dict):
    """(mean loss, {path: gradient}) over the whole batch, summed block by
    block (each block's loss scaled by 1/B)."""
    rows = batch["label"].shape[0]
    paths = [k for k, _ in _leaves(params)]
    leaf = {k: v.detach().requires_grad_(True) for k, v in _leaves(params)}
    tree = _rebuild(params, leaf)
    step = recsys.rows_a_block(model)
    total = torch.zeros((), device=batch["label"].device)
    grads = {k: None for k in paths}
    for lo in range(0, rows, step):
        block = {k: v[lo:lo + step] for k, v in batch.items()}
        with torch.enable_grad():
            part = bce(recsys.logits(tree, model, block), block["label"]).sum() / rows
            gs = torch.autograd.grad(part, [leaf[k] for k in paths], allow_unused=True)
        total += part.detach()
        for k, g in zip(paths, gs):
            if g is not None:
                grads[k] = g if grads[k] is None else grads[k].add_(g)
    return total, {k: torch.zeros_like(leaf[k]) if g is None else g for k, g in grads.items()}


class Trainer:
    """``step(params, state, batch) -> (params, state, {"loss", "finite"})``,
    updating in place, with ``init(params) -> state``."""

    def __init__(self, model: dict, *, adagrad_lr: float, adam_lr: float, clip_norm: float,
                 eps: float = 1e-8, b1: float = 0.9, b2: float = 0.999):
        self.model, self.clip_norm = model, clip_norm
        self.adagrad_lr, self.adam_lr, self.eps, self.b1, self.b2 = adagrad_lr, adam_lr, eps, b1, b2

    def init(self, params: dict) -> dict:
        z = {k: torch.zeros_like(v) for k, v in _leaves(params)}
        sparse = {k: v for k, v in z.items() if SPARSE_KEY in k}
        dense = [k for k in z if SPARSE_KEY not in k]
        return {"sparse": sparse,
                "dense": {"mu": {k: z[k] for k in dense},
                          "nu": {k: torch.zeros_like(z[k]) for k in dense},
                          "count": torch.zeros((), dtype=torch.int32,
                                               device=next(iter(z.values())).device)}}

    @torch.no_grad()
    def step(self, params: dict, state: dict, batch: dict):
        loss, grads = loss_and_grads(params, self.model, batch)
        finite = bool(torch.isfinite(loss))
        if finite:
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
            scale = torch.clamp(self.clip_norm / (norm + 1e-9), max=1.0)
            p = dict(_leaves(params))
            dense = state["dense"]
            count = dense["count"] + 1
            t = count.float()
            c1, c2 = 1 - self.b1 ** t, 1 - self.b2 ** t
            for k, g in grads.items():
                g = g * scale
                if k in state["sparse"]:
                    s = state["sparse"][k]
                    s += g * g
                    p[k] -= self.adagrad_lr * g / (torch.sqrt(s) + self.eps)
                else:
                    m, v = dense["mu"][k], dense["nu"][k]
                    m.mul_(self.b1).add_((1 - self.b1) * g)
                    v.mul_(self.b2).add_((1 - self.b2) * g * g)
                    p[k] -= self.adam_lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            dense["count"] = count
        return params, state, {"loss": loss, "finite": finite}
