"""bert4rec [arXiv:1904.06690; paper].

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200 interaction=bidir-seq —
bidirectional transformer over the item-interaction sequence.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.recsys import RecConfig

CONFIG = RecConfig(
    name="bert4rec", interaction="bidir-seq", embed_dim=64, n_attn_layers=2,
    n_heads=2, seq_len=200, item_vocab=1_000_000, predict_fc=(64, 1),
)

SMOKE = RecConfig(
    name="bert4rec-smoke", interaction="bidir-seq", embed_dim=16,
    n_attn_layers=2, n_heads=2, seq_len=12, item_vocab=500, predict_fc=(8, 1),
)

SPEC = register(ArchSpec(
    arch_id="bert4rec", family="recsys", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:1904.06690",
    notes="bidirectional seq encoder; retrieval head = final hidden · item emb",
))
