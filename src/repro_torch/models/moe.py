"""Top-k MoE with grouped, gather/scatter-based capacity dispatch, the port of
``repro.models.moe``.

Tokens are reshaped to (G, T/G, D), where G is the data-parallel shard count
under the active axis rules (``num_groups``); routing and capacity ranking
happen per group. No (T, E, C) one-hot tensor is made: dispatch and combine
are integer gathers and scatters, and the expert products are batched
matmuls over the experts. Includes the Switch-style auxiliary load-balance
loss.

Nothing here reads a value back to the host, and no shape depends on the
data: a dropped assignment is written into a spare slot column ``C`` that is
sliced off, and the combine's gather clamps its slot as ``mode="clip"`` does,
so that a stage running MoE layers can be captured as a CUDA graph.

``repro`` picks the group count from the rules the step traces under. The
port's data-parallel steps run each device's rows on their own, so they set
the group count of those rows with ``routing`` (``launch/steps.py``), and
form the aux loss there from each layer's routing statistics, which
``loss_fn`` returns, with the top-1 density of the whole batch.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
import threading

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef
from repro_torch.parallel.sharding import current_rules

_STATE = threading.local()


def moe_defs(cfg) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((D, E), ("embed", "experts")),
        "w_gate": ParamDef((E, D, F_), ("experts", "expert_embed", "mlp")),
        "w_up": ParamDef((E, D, F_), ("experts", "expert_embed", "mlp")),
        "w_down": ParamDef((E, F_, D), ("experts", "mlp", "expert_embed")),
    }


def capacity(cfg, tokens_per_group: int) -> int:
    c = int(cfg.capacity_factor * cfg.experts_per_token * tokens_per_group / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def num_groups(total_tokens: int) -> int:
    """Dispatch group count = data-parallel shard count when divisible."""
    r = current_rules()
    if r is None or r.mesh is None:
        return 1
    ax = r.mesh_axes("batch")
    if ax is None:
        return 1
    g = r.axis_size(ax)
    return g if total_tokens % g == 0 else 1


@contextlib.contextmanager
def routing(groups: int):
    """Inside, a decoder stack routes its MoE layers in ``groups`` groups
    instead of ``num_groups``."""
    prev = getattr(_STATE, "groups", None)
    _STATE.groups = groups
    try:
        yield
    finally:
        _STATE.groups = prev


def stack_groups(total_tokens: int) -> int:
    """The group count of a stack over ``total_tokens`` tokens, read once
    where the stack starts: a checkpointed period gets the count as an
    argument, so that its recomputation routes alike."""
    groups = getattr(_STATE, "groups", None)
    return num_groups(total_tokens) if groups is None else groups


def aux_loss(density, mean_probs):
    """Switch load-balance loss E * sum_e density_e * mean_probs_e."""
    return density.shape[-1] * torch.sum(density * mean_probs)


def rank_within_expert(e_idx, E: int):
    """Capacity rank per (token, k) assignment inside each group.

    e_idx: (G, T, K) int64. Returns pos (G, T, K): the k-major arrival rank of
    each assignment at its expert. Memory: one (G, T, E) int64 temp a k."""
    ar = torch.arange(E, device=e_idx.device)
    base = torch.zeros((e_idx.shape[0], 1, E), dtype=torch.long, device=e_idx.device)
    pos = []
    for k in range(e_idx.shape[2]):
        ek = e_idx[..., k:k + 1]
        oh = (ek == ar).long()                                  # (G, T, E)
        excl = oh.cumsum(1) - oh                                # exclusive
        pos.append(torch.gather(excl + base, 2, ek)[..., 0])
        base = base + oh.sum(1, keepdim=True)
    return torch.stack(pos, dim=-1)


@dataclass
class Route:
    """One MoE layer's routing of (G, Tg) tokens to E experts of C slots."""
    probs: torch.Tensor       # (G, Tg, E) f32 router softmax
    e_idx: torch.Tensor       # (G, Tg, K) chosen experts, best first
    gate: torch.Tensor        # (G, Tg, K) f32 renormalised gates, 0 where dropped
    pos: torch.Tensor         # (G, Tg, K) capacity rank at the expert
    keep: torch.Tensor        # (G, Tg, K) pos < C
    slot: torch.Tensor        # (G, Tg, K) e * (C + 1) + (pos if kept else C)
    idx: torch.Tensor         # (G, E, C) token of each slot (0 where empty)
    filled: torch.Tensor      # (G, E, C) 1 where a slot holds a token, x's dtype
    density: torch.Tensor     # (E,) top-1 share of the tokens, no gradient
    mean_probs: torch.Tensor  # (E,)


def route(cfg, router, xt, C: int) -> Route:
    """Top-k routing of ``xt`` (G, Tg, D) and its capacity-C slot table."""
    return route_logits(cfg, (xt @ router).float(), C, xt.dtype)


def route_logits(cfg, logits, C: int, dtype) -> Route:
    """``route`` from the router's f32 logits (G, Tg, E), as a
    tensor-parallel layer has them: the expert shards' columns concatenated.
    ``dtype`` is the tokens' (``filled``'s dtype)."""
    G, Tg, E = logits.shape
    K = cfg.experts_per_token
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    # a stable sort keeps the lower expert first among equal probabilities,
    # as jax.lax.top_k does
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, e_idx = vals[..., :K], order[..., :K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    ar = torch.arange(E, device=dev)
    density = (e_idx[..., :1] == ar).float().mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    pos = rank_within_expert(e_idx, E)
    keep = pos < C
    gate = torch.where(keep, gate, 0.0)
    slot = e_idx * (C + 1) + torch.where(keep, pos, C)          # column C takes the drops
    flat = slot.reshape(G, Tg * K)
    tok = torch.arange(Tg, device=dev).view(1, Tg, 1).expand(G, Tg, K).reshape(G, Tg * K)
    idx = torch.zeros((G, E * (C + 1)), dtype=torch.long, device=dev)
    idx = idx.scatter(1, flat, tok).view(G, E, C + 1)[..., :C]
    filled = torch.zeros((G, E * (C + 1)), dtype=dtype, device=dev)
    filled = filled.scatter(1, flat, 1.0).view(G, E, C + 1)[..., :C]
    return Route(probs, e_idx, gate, pos, keep, slot, idx, filled, density, mean_probs)


def layer_capacity(cfg, x, groups: int | None = None) -> tuple:
    """(G, Tg, C) of a layer over ``x`` (B, S, D): the group count
    (``groups``, else ``num_groups``), tokens a group and slots an expert."""
    T = x.shape[0] * x.shape[1]
    G = num_groups(T) if groups is None else groups
    return G, T // G, capacity(cfg, T // G)


def moe_layer(cfg, p, x, groups: int | None = None):
    """x: (B, S, D) -> (y, Route). ``groups`` defaults to ``num_groups``."""
    G, Tg, C = layer_capacity(cfg, x, groups)
    r = route(cfg, p["router"], x.reshape(G, Tg, x.shape[-1]), C)
    return expert_ffn(cfg, p, x, r), r


def expert_ffn(cfg, p, x, r: Route, first: int = 0):
    """The output (B, S, D) of the experts ``first .. first + E_loc - 1`` on
    ``x`` routed by ``r``, where ``p`` holds those ``E_loc`` experts' weights
    (all of them on one device; an expert shard's under tensor
    parallelism). The other experts' assignments add nothing: a tensor
    parallel layer sums the shards' outputs."""
    B, S, D = x.shape
    E = cfg.num_experts
    G, _, C = r.idx.shape
    T = B * S
    Tg, K = T // G, r.e_idx.shape[-1]
    E_loc = p["w_gate"].shape[0]
    mine = slice(first, first + E_loc)

    # dispatch: gather token embeddings into expert slots, (E_loc, G*C, D)
    offset = (torch.arange(G, device=x.device) * Tg).view(G, 1, 1)
    tok = (r.idx[:, mine] + offset).transpose(0, 1).reshape(E_loc, G * C)
    xe = x.reshape(T, D)[tok] * r.filled[:, mine].transpose(0, 1).reshape(E_loc, G * C, 1)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).view(E_loc, G, C, D).transpose(0, 1)   # (G, E_loc, C, D)

    if cfg.moe_combine == "scatter":
        # combine on the expert side: weight each slot's output by its
        # token's gate and scatter-add into the tokens (duplicates add up)
        gate_slot = torch.zeros((G, E * (C + 1)), dtype=torch.float32, device=x.device)
        gate_slot = gate_slot.scatter_add(1, r.slot.reshape(G, Tg * K), r.gate.reshape(G, Tg * K))
        weighted = ye * gate_slot.view(G, E, C + 1)[:, mine, :C, None].to(x.dtype)
        y = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
            0, (r.idx[:, mine] + offset).reshape(-1), weighted.reshape(G * E_loc * C, D))
    else:
        # combine: gather each assignment's expert output, weight, sum over
        # K. A dropped assignment's slot, or one of another shard's expert,
        # is clamped into range as mode="clip" does: junk, its gate is 0
        flat_slot = (r.slot - r.slot // (C + 1)).clamp_max(E * C - 1) - first * C
        flat_slot = flat_slot.clamp(0, E_loc * C - 1) + offset // Tg * (E_loc * C)
        gate = torch.where((r.e_idx >= first) & (r.e_idx < first + E_loc), r.gate, 0.0)
        yk = ye.reshape(G * E_loc * C, D)[flat_slot.reshape(G, Tg * K)].view(G, Tg, K, D)
        y = torch.sum(yk * gate[..., None].to(x.dtype), dim=2)
    return y.reshape(B, S, D)


def moe_fwd(cfg, p, x):
    """x: (B, S, D) -> (y, aux_loss), as ``repro.models.moe.moe_fwd``."""
    y, r = moe_layer(cfg, p, x)
    return y, aux_loss(r.density, r.mean_probs)
