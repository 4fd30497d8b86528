"""Decoder stack: repeating layer periods (cfg.pattern), one Python loop
iteration per period, each optionally under activation checkpointing.
Parameters and caches keep ``repro``'s layout, with a leading
``num_periods`` dim on every leaf.

Each layer is a mixer ('A' attention or 'M' Mamba-2) and an optional FFN:
dense SwiGLU, or MoE on the layers ``cfg.moe_every`` picks.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamDef, index_tree, mlp_defs, mlp_fwd, rms_norm, stack_defs, unstack_tree)


def _layer_is_moe(cfg, j: int) -> bool:
    return cfg.num_experts > 0 and cfg.d_ff > 0 and j % cfg.moe_every == cfg.moe_every - 1


def layer_defs(cfg, j: int, ch: str) -> dict:
    D = cfg.d_model
    defs = {"norm1": ParamDef((D,), ("embed",), init="ones"),
            "mixer": attn.attn_defs(cfg) if ch == "A" else ssm_mod.ssm_defs(cfg)}
    if cfg.d_ff > 0:
        defs["norm2"] = ParamDef((D,), ("embed",), init="ones")
        defs["ffn"] = moe_mod.moe_defs(cfg) if _layer_is_moe(cfg, j) else mlp_defs(D, cfg.d_ff)
    return defs


def period_defs(cfg) -> dict:
    return {f"layer{j}": layer_defs(cfg, j, ch) for j, ch in enumerate(cfg.pattern)}


def stacked_defs(cfg) -> dict:
    return stack_defs(period_defs(cfg), cfg.num_periods)


def _ffn(cfg, lp, x, j: int, groups: int):
    """The layer's FFN with its residual: (x, route), route the MoE layer's
    ``moe.Route`` (None on a dense layer or none at all)."""
    if cfg.d_ff <= 0:
        return x, None
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    if _layer_is_moe(cfg, j):
        y, r = moe_mod.moe_layer(cfg, lp["ffn"], h, groups)
        return x + y, r
    return x + mlp_fwd(lp["ffn"], h), None


# --------------------------------------------------------------- forward

def _layer_fwd(cfg, lp, x, pos, j: int, ch: str, groups: int):
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    if ch == "A":
        mix, _ = attn.attention(cfg, lp["mixer"], h, pos)
    else:
        mix, _ = ssm_mod.mamba_fwd(cfg, lp["mixer"], h)
    return _ffn(cfg, lp, x + mix, j, groups)


def period_fwd(cfg, pparams, x, pos, groups: int = 1):
    """One period of layers, MoE layers routed in ``groups`` groups. Returns
    (x, aux, stats): aux the sum of the MoE layers' losses, stats their
    ``(density, mean_probs)`` in layer order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = []
    for j, ch in enumerate(cfg.pattern):
        x, r = _layer_fwd(cfg, pparams[f"layer{j}"], x, pos, j, ch, groups)
        if r is not None:
            aux = aux + moe_mod.aux_loss(r.density, r.mean_probs)
            stats.append((r.density, r.mean_probs))
    return x, aux, tuple(stats)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of matmuls without batch dims (the projections), as
    JAX's ``dots_with_no_batch_dims_saveable``; recompute everything else.
    The MoE expert products are ``bmm``s over the experts, a batch dim, so
    they are recomputed, as in ``repro``."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = {
    "full": None,          # save only each period's input, recompute the rest
    "dots": _save_dots,    # also save the projections' outputs
    "none": "everything",  # save everything: no checkpoint
}


def stack_fwd(cfg, stacked, x, pos, remat: bool = True, remat_policy: str = "full"):
    """x: (B, S, D) -> (x, total aux, stats), stats every MoE layer's
    ``(density, mean_probs)`` in layer order. ``stacked``: period params with
    a leading dim of periods (all of them, or a pipeline stage's span). With
    ``remat``, each period runs under ``torch.utils.checkpoint`` and
    ``remat_policy`` picks what it saves for the backward pass (a
    recompute-against-memory trade). MoE layers route in
    ``moe.stack_groups`` groups."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}; known: {sorted(REMAT_POLICIES)}")
    policy = REMAT_POLICIES[remat_policy]
    fn = period_fwd
    if remat and policy != "everything":
        kw = {} if policy is None else {
            "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}

        def fn(cfg, pparams, x, pos, groups):
            return checkpoint(period_fwd, cfg, pparams, x, pos, groups, use_reentrant=False,
                              **kw)

    groups = moe_mod.stack_groups(x.shape[0] * x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = ()
    for pparams in unstack_tree(stacked):
        x, a, st = fn(cfg, pparams, x, pos, groups)
        aux = aux + a
        stats += st
    return x, aux, stats


# --------------------------------------------------------------- decode

def init_stacked_cache(cfg, batch: int, cache_len: int, dtype, device):
    cache = {}
    for j, ch in enumerate(cfg.pattern):
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
    Returns (x, cache). MoE layers route the (B, 1, D) step as ``repro``'s
    decode does, their aux loss dropped."""
    groups = moe_mod.stack_groups(x.shape[0] * x.shape[1])
    for i in range(cfg.num_periods):
        pparams, pcache = index_tree(stacked, i), index_tree(cache, i)
        for j, ch in enumerate(cfg.pattern):
            lp = pparams[f"layer{j}"]
            h = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if ch == "A":
                mix, _ = attn.decode_attention(cfg, lp["mixer"], h, pcache[f"layer{j}"], pos)
            else:
                mix, _ = ssm_mod.mamba_decode(cfg, lp["mixer"], h, pcache[f"layer{j}"])
            x, _ = _ffn(cfg, lp, x + mix, j, groups)
    return x, cache
