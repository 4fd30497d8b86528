"""Plain PyTorch versions of the kernels: the CPU path, and what the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-softmax attention. q/k/v: (B, H, S, hd) (same H).
    Returns (B, H, S, hd) in q's dtype."""
    S = q.shape[2]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def ref_gqa_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd).
    Repeats each KV head for its G = H // KV query heads, then
    ``ref_attention``."""
    G = q.shape[2] // k.shape[2]
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    o = ref_attention(q.transpose(1, 2), kh, vh, causal=causal, window=window)
    return o.transpose(1, 2)
