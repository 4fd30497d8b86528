"""Builders for the prefill and serve steps. One device, so no axis rules."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B, 1, V)."""
    def prefill(params, batch):
        return model_mod.prefill_step(cfg, params, batch)
    return prefill


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, tokens (B, 1), pos) -> greedy next
    token (B, 1) and the cache, updated in place."""
    def serve(params, cache, tokens, pos: int):
        logits, cache = model_mod.decode_step(cfg, params, cache, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache
    return serve
