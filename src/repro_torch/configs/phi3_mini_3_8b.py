"""phi3-mini-3.8b [arXiv:2404.14219; unverified].

32L d_model=3072 32H (GQA kv=32 == MHA) d_ff=8192 vocab=32064 — RoPE SwiGLU.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064, head_dim=96, dtype="bfloat16",
    remat=True,
)

SMOKE = LMConfig(
    name="phi3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16, dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="phi3-mini-3.8b", family="lm", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:2404.14219", notes="MHA (kv=32); RoPE SwiGLU",
))
