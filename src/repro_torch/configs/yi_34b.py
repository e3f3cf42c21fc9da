"""yi-34b [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — llama-arch GQA.
"""
from repro_torch.configs.registry import ArchSpec, register
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, dtype="bfloat16",
)

SMOKE = LMConfig(
    name="yi-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=8, dtype="float32",
)

SPEC = register(ArchSpec(
    arch_id="yi-34b", family="lm", config=CONFIG, smoke_config=SMOKE,
    source="arXiv:2403.04652", notes="largest assigned dense LM (34B)",
))
