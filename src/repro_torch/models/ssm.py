"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), the
counterpart of ``repro.models.ssm``.

Training and prefill run the chunked SSD algorithm: an intra-chunk quadratic
(attention-like) term plus an inter-chunk linear recurrence. The model's own
``ssd_chunked`` computes it, differentiably, as ``repro``'s model always
does. With ``cfg.attn_impl == "pallas"`` (inference only) the scan goes
through ``kernels.ops.mamba_ssd`` instead: the CUDA kernel on the card, its
plain version on the CPU. Decode is the O(1) recurrent state update.

State layout: h (B, nheads, head_dim, d_state) in f32; conv ring
(B, K-1, conv_ch) in the config's dtype.

Under tensor parallelism a mixer splits by heads (``parallel/tensor.py``):
each shard runs ``mixer_in`` (or ``decode_in``) over its columns, the
shards' ``B|C`` are gathered, each runs ``mixer_scan`` (``decode_state``)
over its heads and ``gate``, the sums of squares are summed over the
shards, and ``mixer_norm`` and the shard's rows of ``out_proj`` give its
partial of the output. The one-device mixer is the same steps with one
shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mamba_ssd
from repro_torch.models.layers import ParamDef, rms_norm


def ssm_defs(cfg) -> dict:
    D = cfg.d_model
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    g = cfg.ssm_ngroups
    conv_ch = di + 2 * g * ds
    in_dim = 2 * di + 2 * g * ds + nh
    return {
        "in_proj": ParamDef((D, in_dim), ("embed", "ssm_inner")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_ch), (None, "ssm_inner")),
        "conv_b": ParamDef((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros"),
        "D_skip": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((di, D), ("ssm_inner", "embed")),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, kernel K. xbc: (B, S, C); w: (K, C). A sum of
    shifted products, as the JAX version, so bf16 rounds where it rounds."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _segsum_decay(a):
    """a: (..., Q) per-step log-decays -> (..., Q, Q) lower-triangular decay
    L[i, j] = exp(sum_{j < t <= i} a_t) for j <= i else 0.

    The upper triangle is masked before ``exp``, where the JAX version masks
    after it: there ``cum_i - cum_j`` is positive and overflows to inf once a
    chunk's decay passes about 88 (full-width mamba2-130m reaches about 95),
    and ``where``'s backward then multiplies that inf by 0. The values are the
    same; the gradient stays finite."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]                 # (..., i, j)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return torch.exp(torch.where(mask, diff, float("-inf")))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan, the counterpart of ``repro.models.ssm.ssd_chunked``.

    x: (B, S, nh, hd) inputs (post-conv); dt: (B, S, nh) softplus'd step
    sizes; A: (nh,) negative decay rates; Bm, Cm: (B, S, nh, ds) input and
    output gates (groups already broadcast to heads). Returns y (B, S, nh, hd)
    in x's dtype and the final state h (B, nh, hd, ds) in f32.
    """
    Bb, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    h = torch.zeros(Bb, nh, hd, ds, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        a_h = (dtq * A).float().transpose(1, 2)                   # (B, nh, Q)
        L = _segsum_decay(a_h)                                    # (B, nh, Q, Q)
        cum = torch.cumsum(a_h, dim=-1)
        total = torch.exp(cum[..., -1])                           # (B, nh)
        xdt = xq * dtq[..., None]                                 # (B, Q, nh, hd)

        # intra-chunk: (C Bᵀ ⊙ L) @ (x·dt)
        scores = torch.einsum("bqhs,bkhs->bhqk", Cq, Bq).float()
        y_intra = torch.einsum("bhqk,bkhd->bqhd", scores * L, xdt.float())

        # inter-chunk: contribution of the carried state
        decay_in = torch.exp(cum).transpose(1, 2)                 # (B, Q, nh)
        y_inter = torch.einsum("bqhs,bhds->bqhd", Cq.float(), h) * decay_in[..., None]

        # state update: h' = h * exp(sum a) + Σ_j exp(cum_Q - cum_j) dt_j x_j B_j
        decay_out = torch.exp(cum[..., -1:] - cum).transpose(1, 2)   # (B, Q, nh)
        h = h * total[..., None, None] + torch.einsum(
            "bqhd,bqhs->bhds", (xdt * decay_out[..., None]).float(), Bq.float())
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), h


def shard_widths(cfg, m: int = 1) -> tuple:
    """A shard's widths of the packed columns ``[z | x | B|C | dt]`` of
    ``in_proj``, one of ``m`` split by heads: (d_inner / m, 2·g·ds / m,
    nheads / m); ``m`` 1 is the whole layer."""
    return (cfg.d_inner // m, 2 * cfg.ssm_ngroups * cfg.ssm_state // m, cfg.ssm_nheads // m)


def packed_segments(cfg) -> dict:
    """The segments of each packed leaf's split dim, in order: a shard of a
    mixer split by heads holds ``1 / m`` of each, its heads' ``z``, ``x`` and
    ``dt`` columns and its share of ``B|C`` (``parallel/tensor.py``)."""
    di, bc, nh = shard_widths(cfg)
    return {"in_proj": (di, di, bc, nh), "conv_w": (di, bc), "conv_b": (di, bc)}


def _head_groups(t, first: int, n: int, nh: int):
    """``t`` (..., g, ds) cut to the groups that heads ``[first, first + n)``
    of ``nh`` read, so that head ``i`` of the ``n`` reads group ``i // (n //
    g')`` of the result, as the scans index groups."""
    rep = nh // t.shape[-2]
    lo, hi = first // rep, (first + n - 1) // rep + 1
    if hi - lo == 1 or (first % rep == 0 and n % rep == 0):
        return t[..., lo:hi, :]
    return t.repeat_interleave(rep, dim=-2)[..., first:first + n, :]


def mixer_in(cfg, p, u, m: int = 1):
    """The in-projection and causal conv of a mixer, or of one of ``m``
    shards split by heads (``p`` its columns of ``in_proj`` and channels of
    the conv, as ``packed_segments``). u: (B, S, D). Returns (z, x, bc, dt):
    x and bc after the conv, bc this shard's share of ``B|C``."""
    di, bc, nh = shard_widths(cfg, m)
    z, xbc, dt = torch.split(u @ p["in_proj"], [di, di + bc, nh], dim=-1)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    x, bc = torch.split(xbc, [di, bc], dim=-1)
    return z, x, bc, dt


def mixer_scan(cfg, p, x, bc, dt, m: int = 1, j: int = 0):
    """The SSD scan over the heads of shard ``j`` of ``m``: x (B, S, di / m)
    its heads' channels, bc (B, S, 2·g·ds) the whole ``B|C``, dt its heads'
    raw steps. Returns (y (B, S, di / m) with the D skip, final state h)."""
    B, S = x.shape[:2]
    ds, g, nh, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads, cfg.ssm_head_dim
    n = nh // m
    # views of the conv's output: the kernel reads them in place
    x = x.reshape(B, S, n, hd)
    Bm, Cm = torch.split(bc, [g * ds, g * ds], dim=-1)
    Bm = _head_groups(Bm.reshape(B, S, g, ds), j * n, n, nh)
    Cm = _head_groups(Cm.reshape(B, S, g, ds), j * n, n, nh)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if cfg.attn_impl == "pallas":
        y, h = mamba_ssd(x, dt, A, Bm, Cm, p["D_skip"], chunk=cfg.ssm_chunk)
    elif cfg.attn_impl == "jnp":
        rep = n // Bm.shape[2]
        y, h = ssd_chunked(x, dt, A, Bm.repeat_interleave(rep, dim=2),
                           Cm.repeat_interleave(rep, dim=2), cfg.ssm_chunk)
        y = y + x * p["D_skip"][None, None, :, None]
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return y.reshape(B, S, n * hd), h


def gate(y, z):
    """A shard's gated norm input ``y · silu(z)`` and the f32 sum of its
    squares over the shard's channels (B, S, 1)."""
    yz = y * F.silu(z)
    return yz, torch.sum(yz.float() ** 2, dim=-1, keepdim=True)


def mixer_norm(cfg, p, yz, sumsq):
    """The gated RMSNorm over the whole ``d_inner``, from ``sumsq`` summed
    over every shard, of the shard's channels: what the shard's rows of
    ``out_proj`` take."""
    y = yz.float() * torch.rsqrt(sumsq / cfg.d_inner + cfg.norm_eps)
    return (y * p["norm"].float()).to(yz.dtype)


def mamba_normed(cfg, p, u):
    """The Mamba-2 mixer before ``out_proj``: (gated, normed y, final state)."""
    z, x, bc, dt = mixer_in(cfg, p, u)
    y, h = mixer_scan(cfg, p, x, bc, dt)
    return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps), h


def mamba_fwd(cfg, p, u):
    """Full-sequence Mamba-2 mixer. u: (B, S, D) -> (y, final_state)."""
    y, h = mamba_normed(cfg, p, u)
    return y @ p["out_proj"], h


def init_ssm_cache(cfg, batch: int, dtype, device):
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    conv_ch = di + 2 * g * ds
    return {
        "h": torch.zeros((batch, nh, cfg.ssm_head_dim, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
    }


SSM_CACHE_AXES = {"h": ("batch", "ssm_heads", None, None),
                  "conv": ("batch", None, "ssm_inner")}


def decode_in(cfg, p, u, cache, m: int = 1):
    """``mixer_in`` of one token u (B, 1, D) against the conv ring of
    ``cache`` (a shard's channels, as its ``conv_w``), which is updated in
    place. Returns (z, x, bc, dt), each (B, 1, ...)."""
    di, bc, nh = shard_widths(cfg, m)
    z, xbc, dt = torch.split(u @ p["in_proj"], [di, di + bc, nh], dim=-1)
    # a new tensor: the ring below is overwritten from it
    window = torch.cat([cache["conv"], xbc], dim=1)                 # (B, K, C)
    conv = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    x, bc = torch.split(conv[:, None], [di, bc], dim=-1)
    return z, x, bc, dt


def decode_state(cfg, p, x, bc, dt, cache, m: int = 1, j: int = 0):
    """The recurrent step of shard ``j``'s heads (``mixer_scan`` of one
    token): ``cache["h"]`` (its heads) is updated in place. Returns y (B, 1,
    di / m)."""
    B = x.shape[0]
    ds, g, nh, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads, cfg.ssm_head_dim
    n = nh // m
    x = x.reshape(B, n, hd)
    Bm, Cm = torch.split(bc[:, 0], [g * ds, g * ds], dim=-1)
    Bm = _head_groups(Bm.reshape(B, g, ds), j * n, n, nh)
    Cm = _head_groups(Cm.reshape(B, g, ds), j * n, n, nh)
    rep = n // Bm.shape[1]
    Bm = Bm.repeat_interleave(rep, dim=1)                            # (B, n, ds)
    Cm = Cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])                # (B, n)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bhd,bhs->bhds", (x * dt[..., None]).float(), Bm.float())
    cache["h"].copy_(h)
    y = torch.einsum("bhs,bhds->bhd", Cm.float(), h)
    y = y.to(x.dtype) + x * p["D_skip"][None, :, None]
    return y.reshape(B, 1, n * hd)


def mamba_decode(cfg, p, u, cache):
    """One-token recurrent step. u: (B, 1, D). Returns (out (B, 1, D), cache).

    ``cache["h"]`` and ``cache["conv"]`` are updated in place, where the JAX
    version returns a new cache.
    """
    z, x, bc, dt = decode_in(cfg, p, u, cache)
    y = decode_state(cfg, p, x, bc, dt, cache)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache
