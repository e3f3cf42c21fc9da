"""Normalization layers; parameters are plain dictionaries of tensors."""
from __future__ import annotations

import torch


def init_layer_norm(dim: int, dtype: torch.dtype = torch.float32, *,
                    device: torch.device | str):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and (population) variance over the last axis, in ``x``'s dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return y * params["scale"] + params["bias"]


def init_rms_norm(dim: int, dtype: torch.dtype = torch.float32, *,
                  device: torch.device | str):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The mean-square is taken in float32, for stability under bfloat16
    activations; the result is cast back to ``x``'s dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    return (y * params["scale"].float()).to(x.dtype)
