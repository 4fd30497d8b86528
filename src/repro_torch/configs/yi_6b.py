"""yi-6b — llama-architecture dense decoder with GQA (kv=4) [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5e6,
    source="arXiv:2403.04652 (Yi)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="yi-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=512, vocab_size=512)
