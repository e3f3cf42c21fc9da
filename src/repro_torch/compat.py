"""Weight conversion from the JAX package's parameter trees.

``jax.random`` streams cannot be reproduced in torch, so parity tests
initialise in JAX, turn every leaf into numpy
(``jax.tree.map(np.asarray, params)``) and hand the tree to
``from_jax_params``.  This module never imports jax.  Layouts are kept as
they are: a linear layer's ``w`` stays ``(d_in, d_out)`` and is applied as
``x @ w``.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, *, device: torch.device | str):
    """dict/list tree of numpy arrays → same-shaped tree of torch tensors
    on ``device``.  Non-array leaves (ints, strings) pass through."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device=device) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return _leaf(np.asarray(tree), device)
    return tree


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":           # ml_dtypes leaf: numpy cannot hand it to torch
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable, contiguous copy
