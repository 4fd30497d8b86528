"""internvl2-26b — InternViT + InternLM2 VLM; we implement the InternLM2-style
language backbone; the ViT encoder + projector is a stub supplying
precomputed patch embeddings via ``input_specs`` [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,
    frontend="vision",
    frontend_tokens=256,    # ViT patch embeddings per image
    source="arXiv:2404.16821 (InternVL2)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-smoke", num_layers=2, d_model=192, num_heads=6,
        num_kv_heads=2, d_ff=384, vocab_size=512, frontend_tokens=8)
