"""Sharding rules: parameter path → spec, per model family, the reference's
rules applied to the port's parameter trees.

A spec is a tuple with, per tensor dimension, the mesh axis it is split
over, a tuple of axes, or ``None`` (what a ``PartitionSpec`` says); ``()``
replicates the tensor.  A rule set returns ``{path: spec}`` for every leaf,
the path in ``jax.tree_util.keystr`` form (``['layers'][0]['attn']['wq']['w']``),
so the reference's regexes apply unchanged.  ``to_placements`` turns a spec
into the DTensor placements of a ``DeviceMesh``.

Axis convention (``launch/mesh.py``):
    pod   — slow inter-pod axis (DP only)
    data  — intra-pod DP (batch) axis; FSDP weight sharding when enabled
    model — TP / EP axis

Families
  * LM: Megatron TP — qkv/ffn-in column-sharded, wo/ffn-out row-sharded over
    ``model``; embeddings vocab-sharded; MoE experts sharded over ``model``
    (EP).  ``fsdp=True`` also shards the largest weight dim over ``data``.
    The port's layers are a list, as the reference's without
    ``scan_layers``; with it the reference prepends a ``None`` for the
    stacked L axis and the rest is the same.
  * RecSys: DLRM hybrid — embedding tables model-parallel (embedding dim over
    ``model`` when it divides, else rows), dense towers replicated.
  * GNN: weights replicated; graph sharded over the batch axes.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Union

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.utils import leaves_with_paths

PyTree = Any
Axis = Optional[Union[str, tuple[str, ...]]]
Spec = tuple[Axis, ...]


def _lm_rules(fsdp: bool, model_size: int):
    d2 = "data" if fsdp else None

    def fit(spec: Spec, shape) -> Spec:
        """Drop the model axis from a dim it does not divide (granite's vocab
        of 49,155 on a 16-way axis): move it to the next divisible free
        dim, else replicate that dim."""
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, (d, sz) in enumerate(zip(dims, shape)):
            if d == "model" and sz % model_size != 0:
                dims[i] = None
                for j, (dj, sj) in enumerate(zip(dims, shape)):
                    if dj is None and sj % model_size == 0 and sj >= model_size:
                        dims[j] = "model"
                        break
        return tuple(dims)

    def rules(path: str, ndim: int, shape) -> Spec:
        spec = None
        if re.search(r"\['embed'\]", path) and ndim == 2:
            spec = ("model", d2)
        elif re.search(r"\['unembed'\].*\['w'\]", path):
            spec = (d2, "model")
        elif re.search(r"\['(wq|wk|wv)'\].*\['w'\]", path):
            spec = (d2, "model")
        elif re.search(r"\['(wq|wk|wv)'\].*\['b'\]", path):
            spec = ("model",)
        elif re.search(r"\['wo'\].*\['w'\]", path):
            spec = ("model", d2)
        # MoE expert stacks (E, d, f) / (E, f, d): EP over model
        elif re.search(r"\['(wg|wu|wd)'\]$", path) and ndim == 3:
            spec = ("model", None, d2)
        # dense SwiGLU
        elif re.search(r"\['(wg|wu)'\].*\['w'\]", path):
            spec = (d2, "model")
        elif re.search(r"\['wd'\].*\['w'\]", path):
            spec = ("model", d2)
        if spec is None:
            return ()                    # router, norms, biases: replicated
        return fit(spec, shape)
    return rules


def lm_param_pspecs(params: PyTree, *, fsdp: bool = False,
                    model_axis_size: int = 16) -> dict[str, Spec]:
    rules = _lm_rules(fsdp, model_axis_size)
    return {p: rules(p, leaf.ndim, tuple(leaf.shape)) for p, leaf in leaves_with_paths(params)}


def recsys_param_pspecs(params: PyTree, *, model_axis_size: int = 16) -> dict[str, Spec]:
    """Embedding tables model-parallel: column (dim) sharding when the
    embedding dim divides the axis (local lookups, a small all-gather at
    the interaction); otherwise row (vocab) sharding, the classic placement
    for narrow tables (xDeepFM's dim-10 tables)."""
    def one(p: str, leaf) -> Spec:
        if "['tables']" in p and leaf.ndim == 3:      # (F, V, D)
            if leaf.shape[2] % model_axis_size == 0:
                return (None, None, "model")
            return (None, "model", None)             # row-sharded
        if "['item_table']" in p and leaf.ndim == 2:  # (V, D)
            if leaf.shape[1] % model_axis_size == 0:
                return (None, "model")
            return ("model", None)
        return ()                                    # dense towers replicated
    return {p: one(p, leaf) for p, leaf in leaves_with_paths(params)}


def gnn_param_pspecs(params: PyTree) -> dict[str, Spec]:
    return {p: () for p, _ in leaves_with_paths(params)}


def param_pspecs(family: str, cfg, params: PyTree, *, fsdp: bool = False) -> dict[str, Spec]:
    if family == "lm":
        return lm_param_pspecs(params, fsdp=fsdp)
    if family == "recsys":
        return recsys_param_pspecs(params)
    if family == "gnn":
        return gnn_param_pspecs(params)
    raise ValueError(family)


# ------------------------------------------------------------- batch specs


def _bx(baxes: tuple[str, ...]) -> Axis:
    return baxes if len(baxes) > 1 else baxes[0]


def recsys_batch_pspecs(batch: PyTree, baxes: tuple[str, ...]) -> dict[str, Spec]:
    bx = _bx(baxes)

    def one(p: str, leaf) -> Spec:
        if "candidates" in p:                          # (B=1, C): shard C
            return (None, bx)
        if leaf.shape and leaf.shape[0] == 1:          # retrieval: B=1 leaves
            return (None,) * leaf.ndim                 # stay replicated
        return (bx,) + (None,) * (leaf.ndim - 1)
    return {p: one(p, leaf) for p, leaf in leaves_with_paths(batch)}


def lm_batch_pspecs(batch: PyTree, baxes: tuple[str, ...]) -> dict[str, Spec]:
    bx = _bx(baxes)
    return {p: (bx,) + (None,) * (leaf.ndim - 1) for p, leaf in leaves_with_paths(batch)}


def lm_cache_pspecs(caches: PyTree, baxes: tuple[str, ...],
                    *, model_axis_size: int = 0) -> dict[str, Spec]:
    """KV caches (B, T, Hkv, D): batch over the data axes; KV heads over
    ``model`` when divisible, else the time dim (decode-time context
    parallelism: each model rank scans its slice of the cache and the
    softmax reduces across ranks), so a long cache is never replicated."""
    bx = _bx(baxes)

    def one(leaf) -> Spec:
        if leaf.ndim == 4:
            if model_axis_size and leaf.shape[2] % model_axis_size == 0:
                return (bx, None, "model", None)
            return (bx, "model", None, None)           # time-sharded
        return (bx,)                                   # pos (B,)
    return {p: one(leaf) for p, leaf in leaves_with_paths(caches)}


def gnn_batch_pspecs(batch: PyTree, baxes: tuple[str, ...]) -> dict[str, Spec]:
    bx = _bx(baxes)

    def one(p: str, leaf) -> Spec:
        if "edge_index" in p and leaf.ndim == 2:       # (2, E): shard edges
            return (None, bx)
        if "edge_index" in p and leaf.ndim == 3:       # (G, 2, E): shard graphs
            return (bx, None, None)
        return (bx,) + (None,) * (leaf.ndim - 1)
    return {p: one(p, leaf) for p, leaf in leaves_with_paths(batch)}


def to_placements(mesh: DeviceMesh, spec: Spec) -> list[Placement]:
    """One placement per mesh dimension: ``Shard(i)`` where tensor dim i is
    split over that mesh axis, else ``Replicate()``."""
    names = mesh.mesh_dim_names
    out: list[Placement] = [Replicate() for _ in names]
    for i, axes in enumerate(spec):
        for a in (axes,) if isinstance(axes, str) else (axes or ()):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
            out[names.index(a)] = Shard(i)
    return out
