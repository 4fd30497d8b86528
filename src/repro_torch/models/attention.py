"""GQA attention: query-chunked causal attention (``attn_impl="jnp"``, the
plain path), the flash kernel (``attn_impl="pallas"``, the CUDA kernel on
the card), and single-token decode against a KV cache.

Shapes: q (B, S, H, hd); k/v (B, S, KV, hd). GQA groups G = H // KV.
"""
from __future__ import annotations

from dataclasses import dataclass
import math

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


@dataclass(frozen=True)
class HeadShard:
    """Shard ``j`` of ``m`` of an attention layer split over its heads
    (``head_shard``): ``cfg`` the config of the heads it attends, and where
    it takes them from gathered columns, else None (its own columns):
    ``q`` its group's columns of q, ``kv`` its group's KV heads of K and V,
    ``out`` its columns of its group's output, which its rows of ``wo``
    take."""
    cfg: object
    q: slice | None
    kv: slice | None
    out: slice | None


def head_shard(cfg, m: int, j: int) -> HeadShard:
    """Shard ``j`` of ``m`` of an attention layer whose ``wq``/``wk``/``wv``
    columns and ``wo`` rows are split in ``m`` contiguous slices. The ``H``
    query heads form ``g = gcd(H, m)`` groups, each computed by the ``m /
    g`` shards that hold its columns: where ``H`` divides (``g = m``) a
    shard's columns are whole heads, else they gather q's columns and each
    attends its group's heads and applies its ``wo`` rows to its own
    columns of the output (the group's attention done by each of its
    shards, as ``repro``'s program divides it). A shard's ``wk``/``wv``
    columns are whole KV heads of its group where ``KV`` divides over
    ``m``; else the K and V columns are gathered and the group attends
    with its own KV heads, each KV head replicated over the shards of its
    groups. Raises ValueError where a group's heads would span a part of
    two KV groups."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = math.gcd(H, m)
    n, G = H // g, H // KV
    if n % G and G % n:
        raise ValueError(f"{H} query heads on {KV} KV heads over {m} shards: a group of {n} "
                         f"query heads would span part of two KV groups of {G}")
    c = j // (m // g)
    if KV % m == 0:
        kv, n_kv = None, KV // m
    else:
        n_kv = max(1, n // G)
        kv = slice(c * n // G, c * n // G + n_kv)
    w = H * hd // m
    i = j % (m // g)
    q = None if g == m else slice(c * n * hd, (c + 1) * n * hd)
    out = None if g == m else slice(i * w, (i + 1) * w)
    return HeadShard(cfg.replace(num_heads=n, num_kv_heads=n_kv, head_dim=hd), q, kv, out)


def project_q(cfg, p, x):
    """x's q columns of ``wq`` (a shard's, or every column), with the bias,
    before rotary."""
    q = x @ p["wq"]
    return q + p["bq"] if cfg.qkv_bias else q


def project_kv(cfg, p, x):
    """x's K and V columns of ``wk`` and ``wv`` (a shard's, or every
    column), with the bias, before rotary: (B, S, n·hd) each."""
    k, v = x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def _project_qkv(cfg, p, x, pos, shard=None, cols=None, select_kv: bool = True):
    """q, k, v of (B, S, heads, hd), q and k rotated. Under ``shard`` (a
    ``HeadShard``) ``cols`` holds the gathered columns it reads: ``"q"`` of
    every query head, ``"k"`` and ``"v"`` of every KV head; its KV heads are
    taken from them unless ``select_kv`` is False (every KV head kept)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = project_q(cfg, p, x) if shard is None or shard.q is None else cols["q"][..., shard.q]
    if shard is None or shard.kv is None:
        k, v = project_kv(cfg, p, x)
    else:
        k, v = cols["k"], cols["v"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if shard is not None and shard.kv is not None and select_kv:
        k, v = k[:, :, shard.kv], v[:, :, shard.kv].contiguous()
    return rotary(q, pos, cfg.rope_theta), rotary(k, pos, cfg.rope_theta), v


def _out(p, o, shard):
    """The output projection of the attended heads ``o`` (B, S, n·hd): a
    shard's rows of ``wo`` take its columns of its group's output."""
    if shard is not None and shard.out is not None:
        o = o[..., shard.out]
    return o @ p["wo"]


def _sdpa_chunk(q, k, v, mask):
    """q: (B, qc, KV, G, hd); k/v: (B, S, KV, hd); mask: (qc, S)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    s = torch.where(mask[None, None, None], s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def attention(cfg, p, x, pos, shard: HeadShard | None = None, cols: dict | None = None):
    """Full (or sliding-window) causal self-attention for prefill.
    x: (B, S, D); pos: (S,) positions. Returns (out (B, S, D), (k, v)).
    Under ``shard`` (``cfg`` its ``cfg``), a shard's partial of the output,
    from the gathered ``cols`` (``_project_qkv``)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, pos, shard, cols)
    if cfg.attn_impl == "pallas":
        o = gqa_flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                block_q=min(128, S), block_k=min(128, S))
        return _out(p, o.reshape(B, S, H * hd), shard), (k, v)
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
    return _out(p, out, shard), (k, v)


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, cache_len, KV, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


KV_CACHE_AXES = ("batch", "cache_seq", "kv_heads", None)


def decode_attention(cfg, p, x, cache, pos: int, shard: HeadShard | None = None,
                     cols: dict | None = None):
    """One-token decode. x: (B, 1, D); cache k/v: (B, Sc, KV, hd) ring buffer
    (the ring only engages when sliding_window > 0). ``pos``: absolute
    position of the new token. Returns (out, cache). ``shard`` and ``cols``
    as in ``attention``; where the shard's KV heads come from gathered
    columns its cache holds every KV head: all are written, and it attends
    with its group's.

    The new k/v are written into ``cache`` in place, where the JAX version
    returns a new cache.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x, torch.arange(pos, pos + 1, device=x.device), shard, cols,
                           select_kv=False)
    cache_len = cache["k"].shape[1]
    slot = pos % cache_len if cfg.sliding_window else pos
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v

    idx = torch.arange(cache_len, device=x.device)
    valid = idx <= slot
    if cfg.sliding_window and pos >= cache_len:
        valid = torch.ones_like(valid)
    ck, cv = cache["k"], cache["v"]
    if shard is not None and shard.kv is not None:
        ck, cv = ck[:, :, shard.kv], cv[:, :, shard.kv]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, ck) * hd ** -0.5
    s = torch.where(valid, s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(cv.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, cv).reshape(B, 1, H * hd)
    return _out(p, o, shard), cache
