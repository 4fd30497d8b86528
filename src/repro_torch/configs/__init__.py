"""Architecture registry: ``get_config(arch)`` / ``get_reduced(arch)``.

Ten assigned architectures (public-literature pool) plus the paper's own
benchmark models (Table 3 of TAG) used by the strategy-search benchmarks.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import (  # noqa: F401
    SHAPES, InputShape, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    LONG_CONTEXT_WINDOW)

_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "yi-6b": "repro_torch.configs.yi_6b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).reduced()


def config_for_shape(arch: str, shape_name: str) -> ModelConfig:
    """Config adjusted for an input shape (sliding-window for long_500k on
    pure-attention archs — the sub-quadratic variant the brief requires)."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family not in ("ssm",) \
            and "A" in cfg.pattern and cfg.sliding_window == 0:
        cfg = cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg
