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


def ref_ssd(x, dt, A, B, C):
    """Naive sequential SSD recurrence, as ``repro.kernels.ref.ref_ssd``.

    x: (Bb, S, nh, hd); dt: (Bb, S, nh); A: (nh,); B, C: (Bb, S, nh, ds).
    Returns y (Bb, S, nh, hd) in x's dtype and h (Bb, nh, hd, ds) in f32.
    """
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    dt = dt.float()
    h = torch.zeros(Bb, nh, hd, ds, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dA = torch.exp(dtt * A)                                   # (Bb, nh)
        h = h * dA[..., None, None] + torch.einsum(
            "bhd,bhs->bhds", (xt * dtt[..., None]).float(), Bt.float())
        ys.append(torch.einsum("bhs,bhds->bhd", Ct.float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _segsum_decay(a):
    """a: (..., Q) per-step log-decays -> (..., Q, Q) lower-triangular decay
    L[i, j] = exp(sum_{j < t <= i} a_t) for j <= i else 0."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]                 # (..., i, j)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ref_ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan, as ``repro.models.ssm.ssd_chunked``: per chunk the
    intra-chunk quadratic term plus the carried state's contribution, then
    the state update. Every decay is ``exp`` of a difference of cumulative
    sums, so none underflows to 0/0.

    x: (Bb, S, nh, hd); dt: (Bb, S, nh); A: (nh,) f32; B, C: (Bb, S, nh, ds)
    (groups already broadcast to heads). ``C Bᵀ`` is taken in the input
    dtype and then cast to f32, as the JAX version does. Returns y
    (Bb, S, nh, hd) in x's dtype and the final state h (Bb, nh, hd, ds) in f32.
    """
    Bb, S, nh, hd = x.shape
    ds = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    h = torch.zeros(Bb, nh, hd, ds, dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = x[:, sl], dt[:, sl], B[:, sl], C[:, sl]
        a_h = (dtq * A).float().transpose(1, 2)                   # (Bb, nh, Q)
        L = _segsum_decay(a_h)                                    # (Bb, nh, Q, Q)
        cum = torch.cumsum(a_h, dim=-1)
        total = torch.exp(cum[..., -1])                           # (Bb, nh)
        xdt = xq * dtq[..., None]                                 # (Bb, Q, nh, hd)

        # intra-chunk: (C Bᵀ ⊙ L) @ (x·dt)
        scores = torch.einsum("bqhs,bkhs->bhqk", Cq, Bq).float()
        y_intra = torch.einsum("bhqk,bkhd->bqhd", scores * L, xdt.float())

        # inter-chunk: contribution of the carried state
        decay_in = torch.exp(cum).transpose(1, 2)                 # (Bb, Q, nh)
        y_inter = torch.einsum("bqhs,bhds->bqhd", Cq.float(), h) * decay_in[..., None]

        # h' = h * exp(sum a) + Σ_j exp(cum_Q - cum_j) dt_j x_j B_j
        decay_out = torch.exp(cum[..., -1:] - cum).transpose(1, 2)   # (Bb, Q, nh)
        h = h * total[..., None, None] + torch.einsum(
            "bqhd,bqhs->bhds", (xdt * decay_out[..., None]).float(), Bq.float())
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), h
