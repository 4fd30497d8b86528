"""musicgen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284]. The EnCodec/conv frontend is a stub: ``input_specs``
provides precomputed conditioning frame embeddings (brief carve-out)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    frontend_tokens=256,    # precomputed conditioning frames
    source="arXiv:2306.05284 (MusicGen)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="musicgen-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, d_ff=512, vocab_size=512, frontend_tokens=8)
