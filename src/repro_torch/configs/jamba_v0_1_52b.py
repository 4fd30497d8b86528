"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with 16-expert
top-2 MoE on every other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig

# Jamba block: 8 layers, attention at position 4 (index 3), MoE FFN on every
# second layer. 32 layers = 4 periods of the pattern.
CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_ngroups=1,
    layer_pattern="MMMAMMMM",
    source="arXiv:2403.19887 (Jamba)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="jamba-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=512, num_experts=4,
        experts_per_token=2, ssm_state=16, ssm_head_dim=32,
        layer_pattern="MA")
