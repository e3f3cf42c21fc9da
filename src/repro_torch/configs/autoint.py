"""autoint [arXiv:1810.11921; paper].

n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2 d_attn=32
interaction=self-attn — interacting multi-head attention over field embeddings.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.recsys import RecConfig

CONFIG = RecConfig(
    name="autoint", interaction="self-attn", n_tables=39, vocab=200_000,
    embed_dim=16, hotness=1, n_attn_layers=3, n_heads=2, d_attn=32,
    predict_fc=(1,),
)

SMOKE = RecConfig(
    name="autoint-smoke", interaction="self-attn", n_tables=6, vocab=100,
    embed_dim=8, hotness=1, n_attn_layers=2, n_heads=2, d_attn=4,
    predict_fc=(1,),
)

SPEC = register(ArchSpec(
    arch_id="autoint", family="recsys", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:1810.11921",
    notes="field self-attention; d grows to n_heads*d_attn after layer 1",
))
