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


def _split_proj(cfg, zxbcdt):
    di, ds, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    return torch.split(zxbcdt, [di, di + 2 * g * ds, cfg.ssm_nheads], dim=-1)


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


def mamba_fwd(cfg, p, u):
    """Full-sequence Mamba-2 mixer. u: (B, S, D) -> (y, final_state)."""
    B, S, _ = u.shape
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    z, xbc, dt = _split_proj(cfg, u @ p["in_proj"])
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    # views of xbc: the kernel reads them in place
    x, Bm, Cm = torch.split(xbc, [di, g * ds, g * ds], dim=-1)
    x = x.reshape(B, S, nh, cfg.ssm_head_dim)
    Bm = Bm.reshape(B, S, g, ds)
    Cm = Cm.reshape(B, S, g, ds)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if cfg.attn_impl == "pallas":
        y, h = mamba_ssd(x, dt, A, Bm, Cm, p["D_skip"], chunk=cfg.ssm_chunk)
    elif cfg.attn_impl == "jnp":
        rep = nh // g
        y, h = ssd_chunked(x, dt, A, Bm.repeat_interleave(rep, dim=2),
                           Cm.repeat_interleave(rep, dim=2), cfg.ssm_chunk)
        y = y + x * p["D_skip"][None, None, :, None]
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
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


def mamba_decode(cfg, p, u, cache):
    """One-token recurrent step. u: (B, 1, D). Returns (out (B, 1, D), cache).

    ``cache["h"]`` and ``cache["conv"]`` are updated in place, where the JAX
    version returns a new cache.
    """
    B = u.shape[0]
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    hd = cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, u[:, 0] @ p["in_proj"])           # (B, ...)
    # a new tensor: the ring below is overwritten from it
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)       # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    cache["conv"].copy_(window[:, 1:])
    x, Bm, Cm = torch.split(conv_out, [di, g * ds, g * ds], dim=-1)
    x = x.reshape(B, nh, hd)
    rep = nh // g
    Bm = Bm.reshape(B, g, ds).repeat_interleave(rep, dim=1)          # (B, nh, ds)
    Cm = Cm.reshape(B, g, ds).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])                      # (B, nh)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bhd,bhs->bhds", (x * dt[..., None]).float(), Bm.float())
    cache["h"].copy_(h)
    y = torch.einsum("bhs,bhds->bhd", Cm.float(), h)
    y = y.to(u.dtype) + x * p["D_skip"][None, :, None]
    y = y.reshape(B, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], cache
