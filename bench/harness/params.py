"""The benchmark's own weights, made on the device from the seed, in the
port's parameter layout (``repro_torch/models/recsys.py``): a dictionary
of tensors, linear layers as ``{"w": (d_in, d_out), "b": (d_out,)}``.

The same tensors go to the program and, made again from the same seed, to
the reference.  Tables are drawn in one call into their stacked
``(F, V, D)`` tensor; every draw is normal: weights scaled by
``1/sqrt(fan_in)`` (tables by ``1/sqrt(D)``), biases and the linear logit's
weights by ``BIAS_STD``, small and not zero, as a trained model has them, so
that a forward pass that drops a bias or the linear logit scores wrong.
"""
from __future__ import annotations

import torch

from bench.harness.inputs import generator, substream

BIAS_STD = 0.1


def feature_rows(model: dict) -> int:
    """Rows entering the interaction: a pooled row a table, and the bottom
    MLP's output as one more row when there is a bottom MLP."""
    return model["n_tables"] + (1 if model.get("dense_fc") else 0)


def interaction_width(model: dict) -> int:
    """Width of the dot interaction's output: the pairs below the diagonal
    and the bottom MLP's output beside them."""
    f = feature_rows(model)
    return f * (f - 1) // 2 + model["dense_fc"][-1]


def _small(gen, n: int) -> torch.Tensor:
    return torch.randn(n, generator=gen, device=gen.device).mul_(BIAS_STD)


def _linear(gen, d_in: int, d_out: int) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device).mul_(d_in ** -0.5)
    return {"w": w, "b": _small(gen, d_out)}


def _mlp(gen, d_in: int, widths) -> list:
    out = []
    for w in widths:
        out.append(_linear(gen, d_in, w))
        d_in = w
    return out


def init(model: dict, seed: int, device) -> dict:
    """Weights of a ``dot`` (DLRM) or ``cin`` (xDeepFM) model, float32."""
    if model.get("dtype", "float32") != "float32":
        raise ValueError(f"the benchmark makes float32 weights, not {model['dtype']}")
    gen = generator(substream(seed, 1), device)
    f, v, d = model["n_tables"], model["vocab"], model["embed_dim"]
    p: dict = {"tables": torch.randn((f * v, d), generator=gen, device=gen.device)
               .mul_(d ** -0.5).view(f, v, d)}
    if model["interaction"] == "dot":
        p["dense_mlp"] = _mlp(gen, model["n_dense"], model["dense_fc"])
        p["predict"] = [_mlp(gen, interaction_width(model), model["predict_fc"])]
    elif model["interaction"] == "cin":
        cin, h = [], f
        for n in model["cin_layers"]:
            cin.append(torch.randn((h * f, n), generator=gen, device=gen.device)
                       .mul_((h * f) ** -0.5))
            h = n
        p["cin"] = cin
        p["cin_linear"] = _linear(gen, sum(model["cin_layers"]), 1)
        p["dnn"] = _mlp(gen, f * d, [*model["dnn_widths"], 1])
        p["lin_w"] = _small(gen, f)
    else:
        raise ValueError(f"no weights for interaction {model['interaction']!r}")
    return p


def leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dictionaries in sorted key order, paths
    as ``"['cin'][0]"``: the order and the paths the port's trees use."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in leaves(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]
