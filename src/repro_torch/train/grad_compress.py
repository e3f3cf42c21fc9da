"""Gradient compression for the data-parallel all-reduce.

int8 block-quantised gradients cut the all-reduce's bytes 4x against
float32 (2x against bfloat16); error feedback carries what quantisation
lost into the next step, so the compressed optimiser stays unbiased in the
long run [1-bit Adam / EF-SGD lineage].

The all-reduce itself (the reference's ``compressed_psum``) needs the
port's collectives and comes with its distributed tier.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils import leaves_with_paths, tree_map

PyTree = Any
_BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 of the flattened ``x``, zero-padded to whole
    blocks of 256.  Returns (q int8 (n_blocks, 256), scale float32 (n_blocks, 1))."""
    flat = x.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def init_error_feedback(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: PyTree, residual: PyTree) -> tuple[PyTree, PyTree]:
    """Quantise (grads + residual); return (grads' tree with a (q, scale)
    pair in place of each leaf, new residual)."""
    res = dict(leaves_with_paths(residual))
    out = {}
    for k, g in leaves_with_paths(grads):
        tgt = g.float() + res[k]
        q, scale = quantize_int8(tgt)
        out[k] = (q, scale), tgt - dequantize_int8(q, scale, g.shape, torch.float32)
    return (tree_map(lambda k, _: out[k][0], grads, with_path=True),
            tree_map(lambda k, _: out[k][1], grads, with_path=True))


def decompress_grads(qtree: PyTree, like: PyTree) -> PyTree:
    """``compress_grads``' pairs → tensors of ``like``'s shapes and dtypes."""
    qs = dict(leaves_with_paths(qtree))
    return tree_map(lambda k, g: dequantize_int8(qs[k + "[0]"], qs[k + "[1]"], g.shape, g.dtype),
                    like, with_path=True)
