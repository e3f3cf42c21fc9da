"""Plain PyTorch forward passes of the benchmark's recommendation models,
written from their papers, over the weights in the port's layout.

* ``dot`` (DLRM, arXiv:1906.00091; DeepRecSys's RMC1-3): a bottom MLP over
  the dense features (ReLU after every layer), a sum-pooled bag a table,
  the dot products of every pair of the (bottom output, pooled bags) rows
  below the diagonal in ``tril_indices(F, F, -1)`` order, those products
  followed by the bottom output, then the top MLP (ReLU between layers,
  none after the last): the logit.
* ``cin`` (xDeepFM, arXiv:1803.05170): a hotness-H sum-pooled row a field;
  the CIN, whose layer k maps ``z[b, i·F + j, d] = x^{k-1}[b,i,d]·x^0[b,j,d]``
  by ``W^k (H_{k-1}·F, H_k)`` and is sum-pooled over D, the pooled maps
  concatenated into a linear layer; a DNN over the flattened rows; and the
  linear term ``Σ_f lin_w[f]·Σ_d x0[b,f,d] / D``.  The logit is the sum of
  the three.

Every product is float32; TF32 follows ``torch.backends.cuda.matmul.allow_tf32``,
which the caller sets (off for the reference, on for the control).
Batches are taken in blocks of rows so that the intermediates fit.
"""
from __future__ import annotations

import torch


def pooled(tables: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
    """tables (F, V, D), sparse (B, F, H) ids → (B, F, D) sums of the rows."""
    f = tables.shape[0]
    field = torch.arange(f, device=tables.device)[None, :, None]
    return tables[field, sparse.long()].sum(dim=2)


def mlp(layers: list, x: torch.Tensor, *, relu_last: bool = False) -> torch.Tensor:
    for i, lay in enumerate(layers):
        x = x @ lay["w"] + lay["b"]
        if relu_last or i < len(layers) - 1:
            x = torch.relu(x)
    return x


def dot_pairs(feats: torch.Tensor) -> torch.Tensor:
    """feats (B, F, D) → (B, F(F-1)/2): ⟨feats_i, feats_j⟩ for j < i."""
    f = feats.shape[1]
    gram = feats @ feats.transpose(1, 2)
    i, j = torch.tril_indices(f, f, offset=-1, device=feats.device)
    return gram[:, i, j]


def cin(ws: list, x0: torch.Tensor) -> torch.Tensor:
    """x0 (B, F, D) → (B, ΣH_k): each layer's maps summed over D."""
    b, f, d = x0.shape
    xk, outs = x0, []
    for w in ws:
        z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(b, xk.shape[1] * f, d)
        xk = torch.einsum("bkd,kn->bnd", z, w)
        outs.append(xk.sum(dim=-1))
    return torch.cat(outs, dim=-1)


def logits(params: dict, model: dict, batch: dict) -> torch.Tensor:
    """The logits (B,) of one block of rows."""
    emb = pooled(params["tables"], batch["sparse"])
    if model["interaction"] == "dot":
        bottom = mlp(params["dense_mlp"], batch["dense"], relu_last=True)
        feats = torch.cat([bottom[:, None, :], emb], dim=1)
        z = torch.cat([dot_pairs(feats), bottom], dim=-1)
        return mlp(params["predict"][0], z)[:, 0]
    if model["interaction"] == "cin":
        b = emb.shape[0]
        logit_cin = (cin(params["cin"], emb) @ params["cin_linear"]["w"]
                     + params["cin_linear"]["b"])[:, 0]
        logit_dnn = mlp(params["dnn"], emb.reshape(b, -1))[:, 0]
        logit_lin = (emb.sum(dim=-1) @ params["lin_w"]) / model["embed_dim"]
        return logit_cin + logit_dnn + logit_lin
    raise ValueError(f"no reference for interaction {model['interaction']!r}")


def rows_a_block(model: dict) -> int:
    """Rows a block, so that the largest intermediate stays near 2 GB: the
    gathered rows (B, F, H, D) of a pooled lookup, or the CIN's maps
    (B, H·F, D)."""
    per_row = model["n_tables"] * model["hotness"] * model["embed_dim"]
    if model["interaction"] == "cin":
        h = max([model["n_tables"], *model["cin_layers"]])
        per_row = max(per_row, 2 * h * model["n_tables"] * model["embed_dim"])
    return max(1, (1 << 29) // per_row)


@torch.no_grad()
def forward(params: dict, model: dict, batch: dict) -> torch.Tensor:
    """The logits (B,) of a whole batch, computed block by block."""
    rows = next(iter(batch.values())).shape[0]
    step = rows_a_block(model)
    return torch.cat([logits(params, model, {k: v[lo:lo + step] for k, v in batch.items()})
                      for lo in range(0, rows, step)])
