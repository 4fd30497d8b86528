"""qwen2-1.5b — dense GQA (kv=2) with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671 (Qwen2)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-smoke", num_layers=2, d_model=192, num_heads=6,
        num_kv_heads=2, d_ff=384, vocab_size=512)
