"""Recurrent cells for DIEN: GRU and the attention-gated AUGRU, as a
Python loop over time.

Hand equations, not ``torch.nn.GRU``'s parameterisation: the gates are
computed jointly in the order ``[reset, update, new]``, ``wh`` has no bias,
``gru`` blends ``(1-z)·n + z·h`` and ``augru`` blends ``(1-z)·h + z·n``.
"""
from __future__ import annotations

import torch

from repro_torch.layers.mlp import init_linear, linear


def init_gru(generator: torch.Generator, d_in: int, d_hidden: int, *,
             dtype: torch.dtype = torch.float32, device: torch.device | str):
    return {
        "wi": init_linear(generator, d_in, 3 * d_hidden, bias=True, dtype=dtype,
                          device=device),
        "wh": init_linear(generator, d_hidden, 3 * d_hidden, bias=False, dtype=dtype,
                          device=device),
    }


def _gru_gates(params, gi_t: torch.Tensor, h: torch.Tensor):
    ir, iz, inw = gi_t.chunk(3, dim=-1)
    hr, hz, hnw = linear(params["wh"], h).chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inw + r * hnw)
    return z, n


def _h0(params, xs: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    if h0 is not None:
        return h0
    d_hidden = params["wh"]["w"].shape[0]
    return torch.zeros((xs.shape[0], d_hidden), dtype=xs.dtype, device=xs.device)


def gru(params, xs: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """xs (B, T, d_in) → hidden states (B, T, d_hidden)."""
    h = _h0(params, xs, h0)
    gi = linear(params["wi"], xs)            # input half of the gates, all steps at once
    hs = []
    for t in range(xs.shape[1]):
        z, n = _gru_gates(params, gi[:, t], h)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


def augru(params, xs: torch.Tensor, att: torch.Tensor,
          h0: torch.Tensor | None = None) -> torch.Tensor:
    """DIEN's attention-gated GRU: the update gate is scaled by the
    attention score.  xs (B, T, d_in), att (B, T) → final hidden (B, d_hidden)."""
    h = _h0(params, xs, h0)
    gi = linear(params["wi"], xs)
    for t in range(xs.shape[1]):
        z, n = _gru_gates(params, gi[:, t], h)
        z = z * att[:, t, None]
        h = (1.0 - z) * h + z * n
    return h
