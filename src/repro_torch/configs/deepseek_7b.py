"""deepseek-7b — llama-architecture dense decoder (MHA kv=32) [arXiv:2401.02954]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102_400,
    source="arXiv:2401.02954 (DeepSeek LLM)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=512)
