"""qwen2-0.5b [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA, QKV bias,
tied embeddings (the 0.5B variant ties input/output embeddings).
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, head_dim=64, qkv_bias=True, tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="qwen2-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
    d_ff=128, vocab=256, head_dim=8, qkv_bias=True, tie_embeddings=True,
    dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="qwen2-0.5b", family="lm", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:2407.10671", notes="dense GQA w/ QKV bias",
))
