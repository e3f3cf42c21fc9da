"""Input-shape sets: for the recommendation family the batch of a request
or a pass and the candidate count of retrieval scoring; for the LMs the
sequence (or KV cache) length and the batch; for the GNN the graph (full
batch, sampled minibatch, or a batch of small graphs)."""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32768, 32, "prefill"),
    # one new token per sequence against a KV cache of seq_len slots
    "decode_32k": LMShape("decode_32k", 32768, 128, "decode"),
    # decode with a 524k KV cache needs sub-quadratic attention; the dense
    # LM configs are all full attention (GQA), so it is skipped
    "long_500k": LMShape("long_500k", 524288, 1, "decode"),
}

FULL_ATTENTION_SKIPS = {"long_500k"}


@dataclasses.dataclass(frozen=True)
class RecShape:
    name: str
    batch: int
    kind: str                       # train | serve | retrieval
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecShape("train_batch", 65_536, "train"),
    "serve_p99": RecShape("serve_p99", 512, "serve"),
    "serve_bulk": RecShape("serve_bulk", 262_144, "serve"),
    "retrieval_cand": RecShape("retrieval_cand", 1, "retrieval", 1_000_000),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str                       # full | minibatch | batched
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    n_classes: int = 0
    batch_nodes: int = 0
    fanouts: Sequence[int] = ()
    batch: int = 0                  # batched-small-graphs
    nodes_per_graph: int = 0
    edges_per_graph: int = 0


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", n_nodes=2_708,
                              n_edges=10_556, d_feat=1_433, n_classes=7),
    # Reddit-scale sampled training (d_feat 602 per the source dataset)
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", n_nodes=232_965,
                             n_edges=114_615_892, d_feat=602, n_classes=41,
                             batch_nodes=1_024, fanouts=(15, 10)),
    "ogb_products": GNNShape("ogb_products", "full", n_nodes=2_449_029,
                             n_edges=61_859_140, d_feat=100, n_classes=47),
    "molecule": GNNShape("molecule", "batched", batch=128, nodes_per_graph=30,
                         edges_per_graph=64, d_feat=16, n_classes=2),
}


def shapes_for_family(family: str) -> dict:
    return {"lm": LM_SHAPES, "recsys": RECSYS_SHAPES, "gnn": GNN_SHAPES}[family]
