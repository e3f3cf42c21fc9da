"""MLP stacks: the Dense-FC / Predict-FC blocks of the generalized
recommendation architecture (paper Fig. 2), and the LMs' SwiGLU FFN.

Parameters are plain dictionaries of tensors.  A linear layer stores ``w``
as ``(d_in, d_out)`` and computes ``x @ w`` — the layout of the JAX
package, transposed relative to ``torch.nn.Linear.weight``.  These are
ordinary large matrix products and go to ``torch.matmul``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

_ACTS = {
    "relu": torch.relu,
    # tanh approximation: what the JAX package's gelu computes by default
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def activation(name: str):
    return _ACTS[name]


def init_linear(generator: torch.Generator, d_in: int, d_out: int, *, bias: bool = True,
                dtype: torch.dtype = torch.float32, scale: float | None = None,
                device: torch.device | str):
    scale = scale if scale is not None else (1.0 / max(d_in, 1)) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator, device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def init_mlp(generator: torch.Generator, d_in: int, widths: Sequence[int], *,
             bias: bool = True, dtype: torch.dtype = torch.float32,
             device: torch.device | str):
    """A stack of linear layers; ``mlp`` applies the activation between
    (not after) them."""
    params = []
    prev = d_in
    for w in widths:
        params.append(init_linear(generator, prev, w, bias=bias, dtype=dtype,
                                  device=device))
        prev = w
    return params


def mlp(params, x: torch.Tensor, *, act: str = "relu",
        final_act: str | None = None) -> torch.Tensor:
    """Apply an MLP stack: ``act`` between hidden layers, ``final_act`` (or
    nothing) after the last — the Predict-FC stacks end in a bare logit."""
    f = _ACTS[act]
    n = len(params)
    for i, p in enumerate(params):
        x = linear(p, x)
        if i < n - 1:
            x = f(x)
        elif final_act is not None:
            x = _ACTS[final_act](x)
    return x


def init_ffn_swiglu(generator: torch.Generator, d_model: int, d_ff: int, *,
                    dtype: torch.dtype = torch.float32, device: torch.device | str):
    """LLaMA-style gated FFN: (silu(x W_g) * x W_u) W_d, no biases."""
    kw = dict(bias=False, dtype=dtype, device=device)
    return {"wg": init_linear(generator, d_model, d_ff, **kw),
            "wu": init_linear(generator, d_model, d_ff, **kw),
            "wd": init_linear(generator, d_ff, d_model, **kw)}


def ffn_swiglu(params, x: torch.Tensor) -> torch.Tensor:
    return linear(params["wd"], F.silu(linear(params["wg"], x)) * linear(params["wu"], x))
