"""xdeepfm [arXiv:1803.05170; paper].

n_sparse=39 embed_dim=10 cin_layers=200-200-200 mlp=400-400 interaction=cin.
Criteo-style CTR: 39 categorical fields, CIN + DNN + linear logit sum.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.recsys import RecConfig

CONFIG = RecConfig(
    name="xdeepfm", interaction="cin", n_tables=39, vocab=200_000,
    embed_dim=10, hotness=1, cin_layers=(200, 200, 200),
    dnn_widths=(400, 400),
)

SMOKE = RecConfig(
    name="xdeepfm-smoke", interaction="cin", n_tables=6, vocab=100,
    embed_dim=8, hotness=1, cin_layers=(16, 16), dnn_widths=(32,),
)

SPEC = register(ArchSpec(
    arch_id="xdeepfm", family="recsys", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:1803.05170",
    notes="CIN = outer-product interaction maps + field compression",
))
