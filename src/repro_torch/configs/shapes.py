"""Input-shape sets: for the recommendation family the batch of a request
or a pass and the candidate count of retrieval scoring; for the LMs the
sequence (or KV cache) length and the batch."""
from __future__ import annotations

import dataclasses


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
