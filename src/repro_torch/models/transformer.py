"""Decoder stack: repeating layer periods (cfg.pattern), one Python loop
iteration per period, each optionally under activation checkpointing.
Parameters and caches keep ``repro``'s layout, with a leading
``num_periods`` dim on every leaf.

Each layer is a mixer ('A' attention or 'M' Mamba-2) and an optional dense
SwiGLU FFN. MoE FFN layers raise NotImplementedError until their slice lands
(ROADMAP, queue 1: MoE slice).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamDef, index_tree, mlp_defs, mlp_fwd, rms_norm, stack_defs, unstack_tree)


def _check_layer(cfg, j: int):
    if cfg.num_experts > 0 and cfg.d_ff > 0 and j % cfg.moe_every == cfg.moe_every - 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP: MoE slice)")


def layer_defs(cfg, j: int, ch: str) -> dict:
    _check_layer(cfg, j)
    D = cfg.d_model
    defs = {"norm1": ParamDef((D,), ("embed",), init="ones"),
            "mixer": attn.attn_defs(cfg) if ch == "A" else ssm_mod.ssm_defs(cfg)}
    if cfg.d_ff > 0:
        defs["norm2"] = ParamDef((D,), ("embed",), init="ones")
        defs["ffn"] = mlp_defs(D, cfg.d_ff)
    return defs


def period_defs(cfg) -> dict:
    return {f"layer{j}": layer_defs(cfg, j, ch) for j, ch in enumerate(cfg.pattern)}


def stacked_defs(cfg) -> dict:
    return stack_defs(period_defs(cfg), cfg.num_periods)


def _ffn(cfg, lp, x):
    if cfg.d_ff > 0:
        x = x + mlp_fwd(lp["ffn"], rms_norm(x, lp["norm2"], cfg.norm_eps))
    return x


# --------------------------------------------------------------- forward

def _layer_fwd(cfg, lp, x, pos, j: int, ch: str):
    _check_layer(cfg, j)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if ch == "A":
        mix, _ = attn.attention(cfg, lp["mixer"], h, pos)
    else:
        mix, _ = ssm_mod.mamba_fwd(cfg, lp["mixer"], h)
    return _ffn(cfg, lp, x + mix)


def period_fwd(cfg, pparams, x, pos):
    """One period of layers. Returns (x, aux); aux, the MoE loss, is 0 until
    MoE layers are ported."""
    for j, ch in enumerate(cfg.pattern):
        x = _layer_fwd(cfg, pparams[f"layer{j}"], x, pos, j, ch)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of matmuls without batch dims (the projections), as
    JAX's ``dots_with_no_batch_dims_saveable``; recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {
    "full": None,          # save only each period's input, recompute the rest
    "dots": _save_dots,    # also save the projections' outputs
    "none": "everything",  # save everything: no checkpoint
}


def stack_fwd(cfg, stacked, x, pos, remat: bool = True, remat_policy: str = "full"):
    """x: (B, S, D) -> (x, total aux). ``stacked``: period params with a
    leading dim of periods (all of them, or a pipeline stage's span). With ``remat``, each period runs under
    ``torch.utils.checkpoint`` and ``remat_policy`` picks what it saves for
    the backward pass (a recompute-against-memory trade)."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; known: {sorted(REMAT_POLICIES)}")
    policy = REMAT_POLICIES[remat_policy]
    fn = period_fwd
    if remat and policy != "everything":
        kw = {} if policy is None else {
            "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}

        def fn(cfg, pparams, x, pos):
            return checkpoint(period_fwd, cfg, pparams, x, pos, use_reentrant=False, **kw)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pparams in unstack_tree(stacked):
        x, a = fn(cfg, pparams, x, pos)
        aux = aux + a
    return x, aux


# --------------------------------------------------------------- decode

def init_stacked_cache(cfg, batch: int, cache_len: int, dtype, device):
    cache = {}
    for j, ch in enumerate(cfg.pattern):
        _check_layer(cfg, j)
        if ch == "A":
            per = attn.init_kv_cache(cfg, batch, cache_len, dtype, device)
        else:
            per = ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        cache[f"layer{j}"] = {
            k: t.unsqueeze(0).repeat(cfg.num_periods, *([1] * t.dim()))
            for k, t in per.items()}
    return cache


def cache_axes(cfg) -> dict:
    """The logical axes of every leaf of ``init_stacked_cache``'s cache."""
    axes = {}
    for j, ch in enumerate(cfg.pattern):
        per = ({"k": attn.KV_CACHE_AXES, "v": attn.KV_CACHE_AXES} if ch == "A"
               else ssm_mod.SSM_CACHE_AXES)
        axes[f"layer{j}"] = {k: ("layers", *a) for k, a in per.items()}
    return axes


def stack_decode(cfg, stacked, cache, x, pos: int):
    """One token through every layer; ``cache`` is updated in place.
    Returns (x, cache)."""
    for i in range(cfg.num_periods):
        pparams, pcache = index_tree(stacked, i), index_tree(cache, i)
        for j, ch in enumerate(cfg.pattern):
            _check_layer(cfg, j)
            lp = pparams[f"layer{j}"]
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if ch == "A":
                mix, _ = attn.decode_attention(cfg, lp["mixer"], h, pcache[f"layer{j}"], pos)
            else:
                mix, _ = ssm_mod.mamba_decode(cfg, lp["mixer"], h, pcache[f"layer{j}"])
            x = _ffn(cfg, lp, x + mix)
    return x, cache
