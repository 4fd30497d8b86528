"""minitron-4b — pruned Nemotron dense decoder, GQA kv=8 [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    source="arXiv:2407.14679 (Minitron)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="minitron-smoke", num_layers=2, d_model=192, num_heads=6,
        num_kv_heads=2, d_ff=384, vocab_size=512)
