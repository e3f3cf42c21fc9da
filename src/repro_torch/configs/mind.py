"""mind [arXiv:1904.08030; unverified].

embed_dim=64 n_interests=4 capsule_iters=3 interaction=multi-interest.
User-behavior retrieval model: history → dynamic-routing interest capsules;
serving scores candidates by max-over-capsules dot product.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.recsys import RecConfig

CONFIG = RecConfig(
    name="mind", interaction="mind", embed_dim=64, n_interests=4,
    capsule_iters=3, seq_len=50, item_vocab=1_000_000,
    predict_fc=(128, 64, 1), n_tables=0,
)

SMOKE = RecConfig(
    name="mind-smoke", interaction="mind", embed_dim=16, n_interests=2,
    capsule_iters=2, seq_len=10, item_vocab=500, predict_fc=(16, 1),
)

SPEC = register(ArchSpec(
    arch_id="mind", family="recsys", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:1904.08030",
    notes="multi-interest capsule routing; retrieval head = max over capsules",
))
