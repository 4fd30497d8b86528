"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                 # pure Mamba blocks, no FFN sublayer
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    layer_pattern="M",
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke", num_layers=2, d_model=128, ssm_state=16,
        ssm_head_dim=32, vocab_size=512)
