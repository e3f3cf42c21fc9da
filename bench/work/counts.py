"""Frozen counts of the work a kernel or a model needs, read from the
shapes (and, for K1, from the ids the benchmark made), never from how the
program does it.

* FLOPs are algorithmic, a multiply-add counting 2, at 1×: the three TF32
  passes a float32-accurate product takes on the tensor cores are the
  program's choice, not the work.
* Bytes are every input byte the work needs, read once, and every output
  byte written once, float32.  K1 reads each distinct (table, row) of the
  unit of work once, however often the ids name it.
* A kernel's least time is ``max(bytes / HBM bandwidth, FLOPs / the dense
  TF32 peak)`` (``peaks.json``).

The unit of work is the call that a metric divides: a served request, an
offline pass, a training step.  A weight is read once a unit.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["tf32_flops_per_s"])


def k1(bags: int, hot: int, dim: int, distinct_rows: int) -> tuple[float, float]:
    """K1, sum-pooled lookups: ``bags`` bags (B·F) of ``hot`` ids each, into
    rows of ``dim``: (FLOPs, bytes).  One add a looked-up value; the int32
    ids, each distinct row and the pooled output."""
    return (float(bags * hot * dim),
            float(bags * hot * 4 + distinct_rows * dim * F32 + bags * dim * F32))


def k2(b: int, f: int, d: int) -> tuple[float, float]:
    """K2, DLRM's dot interaction of (B, F, D): the F(F-1)/2 pairs below the
    diagonal, 2·D FLOPs each."""
    pairs = f * (f - 1) // 2
    return float(b * pairs * 2 * d), float((b * f * d + b * pairs) * F32)


def k3(b: int, f: int, h: int, n: int, d: int) -> tuple[float, float]:
    """K3, one CIN layer: x0 (B, F, D), xk (B, H, D), w (H·F, N) → (B, N, D);
    the product of M = B·D rows, K = H·F and N columns."""
    return (float(2 * b * d * h * f * n),
            float((b * f * d + b * h * d + h * f * n + b * n * d) * F32))


def k3_bwd(b: int, f: int, h: int, n: int, d: int) -> tuple[float, float]:
    """K3-bwd, the gradient of one CIN layer from g (B, N, D): the weight
    product zᵀg and the data product g·wᵀ (2·M·K·N each), forming z = xk ⊗ x0
    (M·K) and contracting g·wᵀ against x0 and xk (2·M·K each).  Reads g, x0,
    xk, w; writes dx0, dxk, dw."""
    m, k = b * d, h * f
    flops = 4 * m * k * n + 5 * m * k
    nbytes = (b * n * d + 2 * (b * f * d + b * h * d + k * n)) * F32
    return float(flops), float(nbytes)


def cin_shapes(model: dict) -> list[tuple[int, int, int, int]]:
    """(F, H, N, D) of each CIN layer: layer 1 takes x0 as xk (H = F)."""
    f, d = model["n_tables"], model["embed_dim"]
    out, h = [], f
    for n in model["cin_layers"]:
        out.append((f, h, n, d))
        h = n
    return out


def k3_bound_s(model: dict, items: int) -> float:
    """The least time of a unit's CIN layers over ``items`` rows."""
    return sum(bound_s(*k3(items, f, h, n, d)) for f, h, n, d in cin_shapes(model))


def k3_bwd_bound_s(model: dict, items: int) -> float:
    return sum(bound_s(*k3_bwd(items, f, h, n, d)) for f, h, n, d in cin_shapes(model))


def k1_bound_s(model: dict, items: int, distinct_rows: int) -> float:
    return bound_s(*k1(items * model["n_tables"], model["hotness"], model["embed_dim"],
                       distinct_rows))


def _mlp_flops(d_in: int, widths) -> int:
    total = 0
    for w in widths:
        total += 2 * d_in * w
        d_in = w
    return total


def forward_flops(model: dict) -> float:
    """A scored item's FLOPs: pooling, interaction and every matrix product."""
    f, d, hot = model["n_tables"], model["embed_dim"], model["hotness"]
    pool = f * hot * d
    if model["interaction"] == "dot":
        rows = f + 1
        pairs = rows * (rows - 1) // 2
        bottom = _mlp_flops(model["n_dense"], model["dense_fc"])
        top = _mlp_flops(pairs + model["dense_fc"][-1], model["predict_fc"])
        return float(pool + bottom + pairs * 2 * d + top)
    if model["interaction"] == "cin":
        cin = sum(k3(1, ff, h, n, dd)[0] for ff, h, n, dd in cin_shapes(model))
        head = 2 * sum(model["cin_layers"]) + _mlp_flops(f * d, [*model["dnn_widths"], 1])
        return float(pool + cin + head + 2 * f * d)
    raise ValueError(model["interaction"])


def train_flops(model: dict) -> float:
    """A trained sample's FLOPs: the forward, and a backward of twice the
    forward's products (data and weight gradients) for every layer, the
    CIN's by ``k3_bwd``; the optimiser is not counted."""
    if model["interaction"] != "cin":
        raise ValueError("train counts are written for the cin model only")
    fwd = forward_flops(model)
    cin_fwd = sum(k3(1, f, h, n, d)[0] for f, h, n, d in cin_shapes(model))
    cin_bwd = sum(k3_bwd(1, f, h, n, d)[0] for f, h, n, d in cin_shapes(model))
    return float(fwd + 2 * (fwd - cin_fwd) + cin_bwd)
