"""Weight conversion from the JAX package's parameter trees.

``jax.random`` streams cannot be reproduced in torch, so parity tests
initialise in JAX, turn every leaf into numpy
(``jax.tree.map(np.asarray, params)``) and hand the tree to
``from_jax_params``.  This module never imports jax.  Layouts are kept as
they are: a linear layer's ``w`` stays ``(d_in, d_out)`` and is applied as
``x @ w``.  An LM tree whose layers are stacked (the JAX package's
``scan_layers=True``: ``layers`` is one dictionary whose every leaf has a
leading L axis) becomes the port's list of L layer dictionaries; an MoE
layer's ``moe`` subtree (``router``/``wg``/``wu``/``wd``, the expert stacks
(E, d, f) under the L axis) is unstacked with the rest.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, *, device: torch.device | str):
    """dict/list tree of numpy arrays → same-shaped tree of torch tensors
    on ``device``.  Non-array leaves (ints, strings) pass through, and so
    does a 0-d integer array, as a Python ``int``: that is a static integer
    of the JAX tree (QR's ``num_buckets``) that ``jax.tree.map(np.asarray,
    ...)`` turned into an array, not a weight."""
    if isinstance(tree, dict):
        return {k: from_jax_params(_unstack(v) if k == "layers" and isinstance(v, dict) else v,
                                   device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device=device) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.asarray(tree)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        return _leaf(a, device)
    return tree


def _unstack(tree):
    """A tree of arrays with a leading L axis → a list of L trees."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(np.asarray(t))

    walk(tree)
    n = {a.shape[0] for a in leaves}
    if len(n) != 1:
        raise ValueError(f"stacked layers disagree on their leading axis: {sorted(n)}")

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    return [pick(tree, i) for i in range(n.pop())]


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":           # ml_dtypes leaf: numpy cannot hand it to torch
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable, contiguous copy
