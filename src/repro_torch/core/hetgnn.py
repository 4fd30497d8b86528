"""Heterogeneous GNN (paper §4.2.1, Fig. 2) in PyTorch, the counterpart of
``repro.core.hetgnn``.

Two node types (op groups, device groups), three link types (op-op,
dev-dev, op-dev/dev-op). Each of the 4 layers does GAT-style multi-head
attention aggregation per edge type:

    h_u^{l+1} = AGG_{v in N(u)} gamma_etype * sigma(W_etype [h_v ; e_uv])

with gamma = 1 for same-type edges and 0.1 for cross-type edges (paper's
balance weights). A thin decoder scores a strategy slice (P_i, O_i) from
[sum_j E_dev[j] P_ij ; E_op[i] ; onehot(O_i)] and a softmax over candidate
slices yields the MCTS priors G(s, a).

Parameters are a flat dict of f32 tensors keyed as ``repro``'s (the npz
layout that ``service.registry`` stores); every function runs on the device
the parameters are on, in their dtype, and the featurized graph's numpy
arrays are copied there. ``params_from_numpy`` carries ``repro``'s
parameters across.
"""
from __future__ import annotations

from dataclasses import dataclass
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.features import DEV_F, EDGE_F, OP_F, HetGraph
from repro_torch.core.strategy import Option
from repro_torch.launch.device import resolve_device

GAMMA_SAME = 1.0
GAMMA_CROSS = 0.1
N_OPTIONS = len(Option)
MASKED = -1e30                  # logit of a masked slot, as in ``repro``


@dataclass(frozen=True)
class GNNConfig:
    hidden: int = 48
    heads: int = 4
    layers: int = 4
    decoder_hidden: int = 64


def _dense_init(gen, fan_in, fan_out):
    s = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn((fan_in, fan_out), generator=gen, device=gen.device) * s


def init_gnn(cfg: GNNConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (cuda unless asked otherwise); ``repro``'s keys and shapes."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")
    H = cfg.hidden
    p = {
        "enc_op": _dense_init(generator, OP_F, H),
        "enc_dev": _dense_init(generator, DEV_F, H),
    }
    for layer in range(cfg.layers):
        for et in ("oo", "dd", "od", "do"):
            p[f"W_{layer}_{et}"] = _dense_init(generator, H + EDGE_F, H)
            p[f"b_{layer}_{et}"] = torch.zeros((H,), device=dev)
            p[f"a_{layer}_{et}"] = torch.randn(
                (cfg.heads, 2 * (H // cfg.heads)), generator=generator, device=dev) * 0.1
        p[f"self_{layer}"] = _dense_init(generator, H, H)
    D = cfg.decoder_hidden
    p["dec1"] = _dense_init(generator, 2 * H + N_OPTIONS, D)
    p["dec1b"] = torch.zeros((D,), device=dev)
    p["dec2"] = _dense_init(generator, D, 1)
    return p


def params_from_numpy(d: dict, device=None) -> dict:
    """``repro``'s GNN parameters (numpy or JAX arrays, or a loaded npz) as
    f32 tensors on ``device`` (cuda unless asked otherwise). Tensors that
    already lie there are kept as they are."""
    dev = resolve_device(device)
    out = {}
    for k, v in d.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device=dev, dtype=torch.float32)
        else:
            out[k] = torch.tensor(np.asarray(v, np.float32), device=dev)
    return out


def _where(p: dict):
    """The parameters' device and dtype, where the inputs go."""
    return p["enc_op"].device, p["enc_op"].dtype


def _gat_message(cfg: GNNConfig, W, b, a, h_dst, h_src, e, mask):
    """One edge-type aggregation. h_dst: (U, H); h_src: (V, H);
    e: (U, V, EDGE_F); mask: (U, V) -> (U, H)."""
    U, V = e.shape[0], e.shape[1]
    H = h_dst.shape[-1]
    hd = H // cfg.heads
    src_e = torch.cat([h_src[None, :, :].expand(U, V, H), e], dim=-1)
    m = F.leaky_relu(src_e @ W + b)                        # (U, V, H)
    mh = m.reshape(U, V, cfg.heads, hd)
    dh = h_dst.reshape(U, cfg.heads, hd)
    att_in = torch.cat([dh[:, None].expand(U, V, cfg.heads, hd), mh], dim=-1)
    logits = torch.einsum("uvkd,kd->uvk", F.leaky_relu(att_in), a)
    logits = logits.masked_fill(~mask[..., None], MASKED)
    alpha = torch.softmax(logits, dim=1)
    alpha = alpha.masked_fill(~mask[..., None], 0.0)
    return torch.einsum("uvk,uvkd->ukd", alpha, mh).reshape(U, H)


def _het_arrays(g: HetGraph):
    return (g.op_x, g.dev_x, g.oo_mask, g.oo_e, g.dd_mask, g.dd_e, g.od_e)


def het_tensors(g: HetGraph, device, dtype=torch.float32) -> HetGraph:
    """The featurized graph with its arrays as tensors on ``device`` (masks
    bool, features in ``dtype``); tensors already so are kept as they are."""
    def t(x, dt):
        return torch.as_tensor(x, device=device).to(dt)
    return HetGraph(t(g.op_x, dtype), t(g.dev_x, dtype),
                    t(g.oo_mask, torch.bool), t(g.oo_e, dtype),
                    t(g.dd_mask, torch.bool), t(g.dd_e, dtype),
                    t(g.od_e, dtype))


def gnn_forward(cfg: GNNConfig, p: dict, g: HetGraph):
    """Returns (E_op (N,H), E_dev (M,H))."""
    g = het_tensors(g, *_where(p))
    h_op = g.op_x @ p["enc_op"]
    h_dev = g.dev_x @ p["enc_dev"]
    N, M = h_op.shape[0], h_dev.shape[0]
    od_mask = torch.ones((N, M), dtype=torch.bool, device=h_op.device)
    do_e = g.od_e.transpose(0, 1)
    for layer in range(cfg.layers):
        def msg(et, hd_, hs_, e_, m_, layer=layer):
            return _gat_message(cfg, p[f"W_{layer}_{et}"], p[f"b_{layer}_{et}"],
                                p[f"a_{layer}_{et}"], hd_, hs_, e_, m_)
        new_op = h_op @ p[f"self_{layer}"] \
            + GAMMA_SAME * msg("oo", h_op, h_op, g.oo_e, g.oo_mask) \
            + GAMMA_CROSS * msg("do", h_op, h_dev, g.od_e, od_mask)
        new_dev = h_dev @ p[f"self_{layer}"] \
            + GAMMA_SAME * msg("dd", h_dev, h_dev, g.dd_e, g.dd_mask) \
            + GAMMA_CROSS * msg("od", h_dev, h_op, do_e, od_mask.transpose(0, 1))
        h_op = F.elu(new_op) + h_op
        h_dev = F.elu(new_dev) + h_dev
    return h_op, h_dev


def actions_to_arrays(actions, m: int, bucket: int = 8):
    """(P (A',M), opt (A',5), mask (A',)) padded to a bucket size, as
    ``repro``'s (whose jitted calls hit a small number of compiled shapes
    that way). The port has no compiled shapes to hit: its own callers pass
    ``bucket=1``, since padded slots change no value."""
    A = len(actions)
    Ap = -(-A // bucket) * bucket
    P = np.zeros((Ap, m), np.float32)
    opt = np.zeros((Ap, N_OPTIONS), np.float32)
    mask = np.zeros((Ap,), np.float32)
    for k, a in enumerate(actions):
        for j in a.placement:
            P[k, j] = 1.0
        opt[k, int(a.option)] = 1.0
        mask[k] = 1.0
    return P, opt, mask


def score_actions(cfg: GNNConfig, p: dict, e_op, e_dev, gid, P, opt):
    """Thin decoder: scores for (padded) strategy slices."""
    dev_sum = P @ e_dev                                     # (A, H)
    op_e = e_op[gid][None].expand(P.shape[0], e_op.shape[1])
    x = torch.cat([dev_sum, op_e, opt], dim=-1)
    h = torch.relu(x @ p["dec1"] + p["dec1b"])
    return (h @ p["dec2"])[:, 0]


def action_slices(p: dict, actions, m: int):
    """(P, opt, mask) of ``actions`` as tensors on the parameters' device,
    in one host-to-device copy."""
    dev, dt = _where(p)
    P, opt, mask = actions_to_arrays(actions, m, bucket=1)
    both = torch.from_numpy(np.concatenate([P, opt, mask[:, None]], axis=1)).to(dev, dt)
    return both[:, :m], both[:, m:m + N_OPTIONS], both[:, -1]


def _masked(logits, mask):
    return logits.masked_fill(~(mask > 0), MASKED)


# Split forward pass: the heavy 4-layer GAT encoder and the thin decoder,
# so that callers holding an episode's embeddings fixed
# (core.trainer.CachedPolicy) pay only the decoder per MCTS expansion.

def embed_hetgraph(cfg: GNNConfig, p: dict, g: HetGraph):
    """Encoder half of the policy: (E_op (N,H), E_dev (M,H))."""
    return gnn_forward(cfg, p, g)


def score_embedded(cfg: GNNConfig, p: dict, e_op, e_dev, gid: int, actions, m: int,
                   slices=None):
    """Decoder half: logits for ``actions`` given precomputed embeddings
    (and, where the caller holds them, the actions' ``action_slices``)."""
    P, opt, mask = slices if slices is not None else action_slices(p, actions, m)
    return _masked(score_actions(cfg, p, e_op, e_dev, gid, P, opt), mask)


def policy_logits(cfg: GNNConfig, p: dict, g: HetGraph, gid: int, actions):
    e_op, e_dev = gnn_forward(cfg, p, g)
    return score_embedded(cfg, p, e_op, e_dev, gid, actions, g.dev_x.shape[0])


def policy_probs(cfg: GNNConfig, p: dict, g: HetGraph, gid: int, actions):
    return torch.softmax(policy_logits(cfg, p, g, gid, actions), dim=0)


def record_loss_core(cfg, p, arrays, gid, P, opt, mask, pi):
    """Cross-entropy between GNN prior and (padded) MCTS visit dist.
    ``arrays`` is the HetGraph's fields in order; P, opt, mask and pi are
    tensors (or arrays) of the same slot count."""
    dev, dt = _where(p)
    P, opt, mask, pi = (torch.as_tensor(x, device=dev).to(dt) for x in (P, opt, mask, pi))
    e_op, e_dev = gnn_forward(cfg, p, HetGraph(*arrays))
    logits = _masked(score_actions(cfg, p, e_op, e_dev, gid, P, opt), mask)
    return -torch.sum(pi * torch.log_softmax(logits, dim=0))
