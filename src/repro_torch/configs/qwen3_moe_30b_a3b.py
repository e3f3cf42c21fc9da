"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf].

48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936, MoE 128e top-8.
head_dim=128 per the HF config (decoupled from d_model/n_heads).
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, dtype="bfloat16",
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=256, head_dim=16, n_experts=8, top_k=2, dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="qwen3-moe-30b-a3b", family="lm", config=CONFIG, smoke_config=SMOKE,
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="MoE 128 experts top-8; 3B active of 30B total",
))
