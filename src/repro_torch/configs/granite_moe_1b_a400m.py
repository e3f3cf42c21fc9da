"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    n_experts=32, top_k=8, dtype="bfloat16", remat=True,
)

SMOKE = LMConfig(
    name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=256, head_dim=16, n_experts=8, top_k=2, dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm", config=CONFIG,
    smoke_config=SMOKE, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="MoE 32 experts top-8; fine-grained (d_ff=512 per expert)",
))
