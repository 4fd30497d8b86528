"""GQA attention: query-chunked causal attention (``attn_impl="jnp"``, the
plain path), the flash kernel (``attn_impl="pallas"``, the CUDA kernel on
the card), and single-token decode against a KV cache.

Shapes: q (B, S, H, hd); k/v (B, S, KV, hd). GQA groups G = H // KV.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import gqa_flash_attention
from repro_torch.models.layers import ParamDef, rotary

NEG_INF = -1e30
Q_CHUNK = 1024


def attn_defs(cfg) -> dict:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "wq": ParamDef((D, H * hd), ("embed", "q_heads")),
        "wk": ParamDef((D, KV * hd), ("embed", "kv_heads")),
        "wv": ParamDef((D, KV * hd), ("embed", "kv_heads")),
        "wo": ParamDef((H * hd, D), ("q_heads", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), ("q_heads",), init="zeros")
        defs["bk"] = ParamDef((KV * hd,), ("kv_heads",), init="zeros")
        defs["bv"] = ParamDef((KV * hd,), ("kv_heads",), init="zeros")
    return defs


def shard_config(cfg, m: int):
    """The config of one of ``m`` tensor-parallel shards of an attention
    layer: ``H / m`` query heads and ``KV / m`` KV heads of the same width,
    so that ``attention`` and ``decode_attention`` run on a shard's columns
    of ``wq``, ``wk``, ``wv`` and rows of ``wo`` and return its share of the
    output."""
    return cfg.replace(num_heads=cfg.num_heads // m, num_kv_heads=cfg.num_kv_heads // m,
                       head_dim=cfg.resolved_head_dim)


def _project_qkv(cfg, p, x, pos):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return rotary(q, pos, cfg.rope_theta), rotary(k, pos, cfg.rope_theta), v


def _sdpa_chunk(q, k, v, mask):
    """q: (B, qc, KV, G, hd); k/v: (B, S, KV, hd); mask: (qc, S)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    s = torch.where(mask[None, None, None], s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def attention(cfg, p, x, pos):
    """Full (or sliding-window) causal self-attention for prefill.
    x: (B, S, D); pos: (S,) positions. Returns (out (B, S, D), (k, v))."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, pos)
    if cfg.attn_impl == "pallas":
        o = gqa_flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                block_q=min(128, S), block_k=min(128, S))
        return o.reshape(B, S, H * hd) @ p["wo"], (k, v)
    if cfg.attn_impl != "jnp":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    qg = q.reshape(B, S, KV, H // KV, hd)
    qc = min(cfg.attn_chunk or Q_CHUNK, S)
    if S % qc:
        raise ValueError(f"sequence {S} is not a multiple of the query chunk {qc}")
    kpos = pos
    outs = []
    for i in range(S // qc):
        qpos = i * qc + torch.arange(qc, device=x.device)
        mask = kpos[None, :] <= qpos[:, None]
        if cfg.sliding_window:
            mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
        outs.append(_sdpa_chunk(qg[:, i * qc:(i + 1) * qc], k, v, mask))
    out = torch.cat(outs, dim=1).reshape(B, S, H * hd)
    return out @ p["wo"], (k, v)


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, cache_len, KV, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


KV_CACHE_AXES = ("batch", "cache_seq", "kv_heads", None)


def decode_attention(cfg, p, x, cache, pos: int):
    """One-token decode. x: (B, 1, D); cache k/v: (B, Sc, KV, hd) ring buffer
    (the ring only engages when sliding_window > 0). ``pos``: absolute
    position of the new token. Returns (out, cache).

    The new k/v are written into ``cache`` in place, where the JAX version
    returns a new cache.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, torch.arange(pos, pos + 1, device=x.device))
    cache_len = cache["k"].shape[1]
    slot = pos % cache_len if cfg.sliding_window else pos
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v

    idx = torch.arange(cache_len, device=x.device)
    valid = idx <= slot
    if cfg.sliding_window and pos >= cache_len:
        valid = torch.ones_like(valid)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, cache["k"]) * hd ** -0.5
    s = torch.where(valid, s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(cache["v"].dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, cache["v"]).reshape(B, 1, H * hd)
    return o @ p["wo"], cache
