"""olmoe-1b-7b — 64-expert top-8 MoE, GQA kv=16 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,              # per-expert FFN width
    vocab_size=50_304,
    num_experts=64,
    experts_per_token=8,
    moe_every=1,
    source="arXiv:2409.02060 (OLMoE)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="olmoe-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=64, vocab_size=512, num_experts=4,
        experts_per_token=2)
