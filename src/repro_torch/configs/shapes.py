"""Input-shape sets of the recommendation family: the batch of a request
or a pass, and the candidate count of retrieval scoring."""
from __future__ import annotations

import dataclasses


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
