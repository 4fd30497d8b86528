"""Top-level LM: embeddings, decoder stack (attention, Mamba-2 and MoE
layers), tied or untied head, the training loss, prefill and decode steps.

Audio and vision frontends are stubs, as in ``repro``: ``input_specs``
gives precomputed frame or patch embeddings (``prefix``, (B,
cfg.frontend_tokens, D)); the decoder consumes them, projected by
``frontend_proj``, ahead of the tokens, and the loss covers the token
positions only.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.device import resolve_device
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import (
    ParamDef, abstract_tree, axes_tree, cross_entropy, init_tree, rms_norm)

MAX_SMOKE_AUX = 0.01  # aux-loss weight


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def model_defs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "blocks": tf_mod.stacked_defs(cfg),
        "final_norm": ParamDef((D,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, V), ("embed", "vocab"), scale=0.02)
    if cfg.frontend != "none":
        # learned projection of the (stubbed) frontend embeddings
        defs["frontend_proj"] = ParamDef((D, D), ("embed", "embed"))
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (cuda unless asked otherwise)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")
    return init_tree(model_defs(cfg), generator, torch_dtype(cfg))


def abstract_params(cfg: ModelConfig):
    """The parameters' shapes and dtype as tensors on the ``meta`` device."""
    return abstract_tree(model_defs(cfg), torch_dtype(cfg))


def param_axes(cfg: ModelConfig):
    """The logical axes of every parameter leaf."""
    return axes_tree(model_defs(cfg))


def _head(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return h @ w


def embed_tokens(cfg: ModelConfig, params, tokens):
    """Token embeddings (B, S, D), scaled by sqrt(d_model)."""
    return params["embed"][tokens] * (cfg.d_model ** 0.5)


def embed_inputs(cfg: ModelConfig, params, batch):
    """The decoder stack's input, in ``forward`` and in a pipeline's first
    stage: the token embeddings, behind the projected ``batch["prefix"]``
    where the config has a frontend. Returns (x, pos, n_prefix)."""
    x = embed_tokens(cfg, params, batch["tokens"])
    n_prefix = 0
    if cfg.frontend != "none":
        prefix = batch["prefix"].to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([prefix, x], dim=1)
        n_prefix = prefix.shape[1]
    return x, torch.arange(x.shape[1], device=x.device), n_prefix


def _hidden(cfg, params, batch, remat, remat_policy):
    """``forward``'s (hidden, aux, n_prefix) and the MoE layers' stats."""
    x, pos, n_prefix = embed_inputs(cfg, params, batch)
    x, aux, stats = tf_mod.stack_fwd(cfg, params["blocks"], x, pos, remat=remat,
                                     remat_policy=remat_policy)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, n_prefix, stats


def forward(cfg: ModelConfig, params, batch, remat: bool = True,
            remat_policy: str = "full"):
    """Full-sequence forward of ``batch["tokens"]`` (B, S) (and ``"prefix"``
    where the config has a frontend). Returns (hidden (B, n_prefix + S, D),
    aux loss, n_prefix)."""
    return _hidden(cfg, params, batch, remat, remat_policy)[:3]


def loss_fn(cfg: ModelConfig, params, batch, remat: bool = True,
            loss_chunk: int = 0, remat_policy: str = "full"):
    """Mean next-token CE (+ MoE aux). Returns (loss, {"ce", "aux", "moe"}),
    ``"moe"`` every MoE layer's ``(density, mean_probs)`` in layer order
    (empty without MoE), from which a data-parallel step forms the aux loss
    of the whole batch.

    ``loss_chunk`` > 0 computes the logits in sequence chunks, each under a
    checkpoint, so neither the forward nor the backward pass holds (B, S, V)
    at once."""
    h, aux, n_prefix, stats = _hidden(cfg, params, batch, remat, remat_policy)
    if n_prefix:
        h = h[:, n_prefix:]
    labels = batch["labels"].long()
    S = h.shape[1]
    if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
        def chunk_ce(hb, lb):
            return cross_entropy(_head(cfg, params, hb), lb)

        n = S // loss_chunk
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            sl = slice(i * loss_chunk, (i + 1) * loss_chunk)
            tot = tot + checkpoint(chunk_ce, h[:, sl], labels[:, sl], use_reentrant=False)
        ce = tot / n
    else:
        ce = cross_entropy(_head(cfg, params, h), labels)
    return ce + MAX_SMOKE_AUX * aux, {"ce": ce, "aux": aux, "moe": stats}


# ------------------------------------------------------------- decoding

def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    return tf_mod.init_stacked_cache(cfg, batch, cache_len_for(cfg, seq_len),
                                     torch_dtype(cfg), resolve_device(device))


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """``init_cache``'s leaves as tensors on the ``meta`` device."""
    return init_cache(cfg, batch, seq_len, "meta")


def cache_axes(cfg: ModelConfig):
    return tf_mod.cache_axes(cfg)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1) int64; pos: absolute position.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    x = embed_tokens(cfg, params, tokens)
    x, cache = tf_mod.stack_decode(cfg, params["blocks"], cache, x, pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _head(cfg, params, x), cache


def prefill_step(cfg: ModelConfig, params, batch):
    """Inference prefill: full forward, returns last-position logits (B, 1, V)."""
    h, _, _ = forward(cfg, params, batch, remat=False)
    return _head(cfg, params, h[:, -1:])


# ----------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Every model input of ``shape`` as a tensor on the ``meta`` device.
    Tokens and labels are int64, the port's index dtype; a frontend's prefix
    takes ``cfg.frontend_tokens`` of the sequence, in the model's dtype."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.long):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"tokens": spec(B, 1)}
    n_tok = S - (cfg.frontend_tokens if cfg.frontend != "none" else 0)
    specs = {"tokens": spec(B, n_tok)}
    if cfg.frontend != "none":
        specs["prefix"] = spec(B, cfg.frontend_tokens, cfg.d_model, dtype=torch_dtype(cfg))
    if shape.kind == "train":
        specs["labels"] = spec(B, n_tok)
    return specs
