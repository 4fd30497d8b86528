"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 (paper-table
scale) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,              # per-expert FFN width
    vocab_size=163_840,
    num_experts=384,
    experts_per_token=8,
    moe_every=1,
    source="arXiv:2501.kimi2 (Kimi K2)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="kimi-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=64, vocab_size=512, num_experts=4,
        experts_per_token=2)
