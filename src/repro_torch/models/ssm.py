"""Mamba-2 block (SSD — state-space duality, arXiv:2405.21060), the
counterpart of ``repro.models.ssm``.

Prefill runs the chunked SSD algorithm: an intra-chunk quadratic
(attention-like) term plus an inter-chunk linear recurrence. It goes through
``kernels.ops.mamba_ssd``, whose scan is the CUDA kernel on the card and the
plain chunked version (``ssd_chunked``) on the CPU. Decode is the O(1)
recurrent state update.

State layout: h (B, nheads, head_dim, d_state) in f32; conv ring
(B, K-1, conv_ch) in the config's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mamba_ssd
from repro_torch.kernels.ref import ref_ssd_chunked
from repro_torch.models.layers import ParamDef, rms_norm

ssd_chunked = ref_ssd_chunked


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
    y, h = mamba_ssd(x, dt, A, Bm, Cm, p["D_skip"], chunk=cfg.ssm_chunk)
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
