"""Gradient compression for the data-parallel all-reduce.

int8 block-quantised gradients cut the all-reduce's bytes 4x against
float32 (2x against bfloat16); error feedback carries what quantisation
lost into the next step, so the compressed optimiser stays unbiased in the
long run [1-bit Adam / EF-SGD lineage].

``compressed_psum`` is the data-parallel mean itself over a
``torch.distributed`` group: a shared per-block scale from an all-reduce
(MAX), the int8 payload summed exactly in int32 by an all-reduce (SUM),
dequantised with the shared scales and divided by the group's size.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

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


def compressed_psum(grads: PyTree, group, residual: PyTree) -> tuple[PyTree, PyTree]:
    """int8-compressed data-parallel mean over ``group`` (``None``: the
    default group) with error feedback: (mean tree in the grads' dtypes,
    this rank's new residual, float32).

    Quantise (grads + residual) locally with the per-block scale shared by
    every rank (max over the group of each block's largest magnitude, /127),
    all-reduce the int8 payload accumulated in int32 (exact: no overflow
    below 2^23 ranks), then dequantise with the shared scales.  The residual
    keeps what this rank's quantisation lost."""
    n = dist.get_world_size(group)
    res = dict(leaves_with_paths(residual))
    out = {}
    for k, g in leaves_with_paths(grads):
        tgt = g.float() + res[k]
        numel = tgt.numel()
        flat = torch.nn.functional.pad(tgt.reshape(-1), (0, (-numel) % _BLOCK))
        blocks = flat.reshape(-1, _BLOCK)
        gmax = blocks.abs().amax(dim=1, keepdim=True)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scale = gmax / 127.0 + 1e-12
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
        mean = (qsum.float() * scale).reshape(-1)[:numel].reshape(g.shape) / float(n)
        deq_local = (q.float() * scale).reshape(-1)[:numel].reshape(g.shape)
        out[k] = mean.to(g.dtype), tgt - deq_local
    return (tree_map(lambda k, _: out[k][0], grads, with_path=True),
            tree_map(lambda k, _: out[k][1], grads, with_path=True))
