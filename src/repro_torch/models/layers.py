"""Parameter definitions and basic layers (plain functions on tensors).

Parameters live in nested dicts of tensors with the same keys, shapes and
``(in, out)`` weight layout as ``repro.models.layers``: every leaf is
declared via ``ParamDef`` and materialised by ``init_tree``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                      # logical axis name (or None) per dim
    init: str = "normal"             # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _flatten(defs, prefix=()):
    """(path, ParamDef) pairs in sorted-key order, the order JAX flattens dicts."""
    if isinstance(defs, ParamDef):
        return [(prefix, defs)]
    out = []
    for k in sorted(defs):
        out.extend(_flatten(defs[k], (*prefix, k)))
    return out


def _materialize(d: ParamDef, generator: torch.Generator, dtype: torch.dtype):
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    # drawn in f32, scaled, then cast, as repro.models.layers._materialize
    w = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=dev)
    return (w * d.scale).to(dtype)


def init_tree(defs, generator: torch.Generator, dtype: torch.dtype):
    """Materialise a nested dict of ParamDefs on the generator's device."""
    out: dict = {}
    for path, d in _flatten(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _materialize(d, generator, dtype)
    return out


def abstract_tree(defs, dtype: torch.dtype):
    """Tensors on the ``meta`` device for a nested dict of ParamDefs: shapes
    and dtypes, no storage."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=dtype, device="meta")
    return {k: abstract_tree(v, dtype) for k, v in defs.items()}


def axes_tree(defs):
    """The logical axes of every ParamDef of a nested dict."""
    if isinstance(defs, ParamDef):
        return defs.axes
    return {k: axes_tree(v) for k, v in defs.items()}


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension (one slice per period)."""
    if isinstance(defs, ParamDef):
        return ParamDef((n, *defs.shape), (axis_name, *defs.axes), defs.init, defs.scale)
    return {k: stack_defs(v, n, axis_name) for k, v in defs.items()}


def index_tree(tree, i: int):
    """Slice ``i`` of every leaf's leading dim (views: writes reach ``tree``)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: index_tree(v, i) for k, v in tree.items()}


def unstack_tree(tree) -> list:
    """The slices of every leaf's leading dim (one a period, or a pipeline
    stage's span of periods), as trees of views. One ``unbind`` a leaf: its
    backward stacks the slices' gradients once, where separate
    ``index_tree`` calls would each scatter into a zero-filled copy of the
    whole leaf."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    per = {k: unstack_tree(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


# ---------------------------------------------------------------- layers

def rms_norm(x, gamma, eps: float):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_hidden(p, x):
    """SwiGLU's gated hidden activations, before ``w_down``."""
    return F.silu(x @ p["w_gate"]) * (x @ p["w_up"])


def mlp_fwd(p, x):
    """SwiGLU feed-forward."""
    return mlp_hidden(p, x) @ p["w_down"]


def rotary(x, pos, theta: float):
    """Apply rotary embedding, half-split layout. x: (..., S, H, hd); pos: (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freqs / half)
    angles = pos.to(torch.float32)[..., None] * inv              # (S, half)
    cos = torch.cos(angles)[..., None, :]                         # (S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels):
    """Mean next-token CE in f32. logits: (B, S, V); labels: (B, S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)
