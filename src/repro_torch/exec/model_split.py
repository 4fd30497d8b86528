"""Model adapter: cut a ``ModelConfig`` LM into pipeline stage functions, the
port of ``repro.exec.model_split``.

The decoder stack holds ``num_periods`` period-params (leading dim of every
leaf under ``params["blocks"]``), so a stage is a contiguous period span plus
the edges: stage 0 owns the embedding (and the frontend projection), the last
stage owns the final norm, the head and the loss.

Stage functions share one signature the engine understands:

    fn(stage_params, carry, mb) -> carry            (stages 0..S-2)
    fn(stage_params, carry, mb) -> (loss, metrics)  (last stage)

``carry`` is ``(hidden (B, S, D), aux (B,))``: the MoE aux loss rides along
as a per-example vector, so that it splits over a stage's data-parallel
shards with the activations. Each shard's MoE layers route its rows as one
group, with that shard's aux loss, as ``repro``'s stages under ``shard_map``
do.

Tied embeddings: the head weight is the embedding matrix, which lives on
stage 0. ``split_model`` then leaves the head out of the last stage's params;
the engine hands the embedding to the last stage each step (``tied_ref``)
and folds the head gradient back into the embedding gradient.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import cross_entropy, rms_norm

TIED_HEAD = "tied_head"      # engine-injected key on the last stage


def _first_stage(cfg: ModelConfig):
    def fn(p, carry, mb):
        del carry
        x, _, _ = model_mod.embed_inputs(cfg, p, mb)
        aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        return _run_blocks(cfg, p, x, aux)
    return fn


def _mid_stage(cfg: ModelConfig):
    def fn(p, carry, mb):
        del mb
        x, aux = carry
        return _run_blocks(cfg, p, x, aux)
    return fn


def _run_blocks(cfg, p, x, aux):
    blocks = p.get("blocks")
    if blocks:
        pos = torch.arange(x.shape[1], device=x.device)
        x, a, _ = tf_mod.stack_fwd(cfg, blocks, x, pos, remat=False)
        aux = aux + a                   # scalar broadcasts over (B,)
    return x, aux


def _last_stage(cfg: ModelConfig, tied: bool):
    def fn(p, carry, mb):
        x, aux = carry
        x, aux = _run_blocks(cfg, p, x, aux)
        h = rms_norm(x, p["final_norm"], cfg.norm_eps)
        labels = mb["labels"].long()
        n_prefix = h.shape[1] - labels.shape[1]
        if n_prefix:
            h = h[:, n_prefix:]
        w = p[TIED_HEAD] if tied else p["head"]
        ce = cross_entropy(h @ w.T if tied else h @ w, labels)
        loss = ce + model_mod.MAX_SMOKE_AUX * torch.mean(aux)
        return loss, {"ce": ce, "aux": torch.mean(aux)}
    return fn


def _single_stage(cfg: ModelConfig, tied: bool):
    """Degenerate 1-stage pipeline (embed + blocks + head in one)."""
    first, last = _first_stage(cfg), _last_stage(cfg, tied=False)

    def fn(p, carry, mb):
        carry = first(p, carry, mb)
        # first() already ran the decoder blocks; hand last() a blocks-free
        # view so that it only applies norm + head + loss
        p_last = {k: v for k, v in p.items() if k != "blocks"}
        if tied:
            p_last["head"] = p["embed"].T
        return last(p_last, carry, mb)
    return fn


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def split_model(cfg: ModelConfig, params, n_stages: int, splits: list | None = None):
    """-> (stage_params, stage_fns, mb_keys, tied_ref).

    ``splits`` is the per-stage [lo, hi) period span (default: equal chunks;
    pass ``StagePlan.layer_splits(cfg.num_periods)`` for the capacity-aware
    cut). A stage's blocks are views of ``params``' leaves. ``mb_keys[s]``
    names the microbatch entries stage ``s`` consumes. ``tied_ref`` is
    ``("embed", TIED_HEAD)`` when the head is tied to the stage-0 embedding,
    else None.
    """
    P = cfg.num_periods
    if splits is None:
        splits = [(s * P // n_stages, (s + 1) * P // n_stages) for s in range(n_stages)]
    assert len(splits) == n_stages and splits[0][0] == 0 and splits[-1][1] == P, splits

    tied = cfg.tie_embeddings
    stage_params, stage_fns, mb_keys = [], [], []
    for s, (lo, hi) in enumerate(splits):
        p = {"blocks": _slice(params["blocks"], lo, hi)}
        keys: list = []
        if s == 0:
            p["embed"] = params["embed"]
            keys.append("tokens")
            if cfg.frontend != "none":
                p["frontend_proj"] = params["frontend_proj"]
                keys.append("prefix")
            fn = _first_stage(cfg)
        else:
            fn = _mid_stage(cfg)
        if s == n_stages - 1:
            p["final_norm"] = params["final_norm"]
            if not tied:
                p["head"] = params["head"]
            keys.append("labels")
            fn = _last_stage(cfg, tied) if s > 0 else _single_stage(cfg, tied)
        stage_params.append(p)
        stage_fns.append(fn)
        mb_keys.append(keys)
    tied_ref = ("embed", TIED_HEAD) if tied and n_stages > 1 else None
    return stage_params, stage_fns, mb_keys, tied_ref
