"""AdamW on the port's parameter trees (nested dicts of tensors), the
counterpart of ``repro.optim.adam``, with the same arithmetic in the same
order, so that f32 results agree bit for bit.

State: first and second moments in ``state_dtype`` (f32 by default, bf16 as a
memory lever) with the arithmetic in f32. Where the JAX version returns new
trees, ``adamw_update`` writes the new parameters and moments into the given
tensors and returns those same trees: the port keeps one copy of each.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"

    def init(self, params):
        return adamw_init(params, self.state_dtype)

    def update(self, params, state, grads, step: int, lr=None):
        return adamw_update(self, params, state, grads, step,
                            self.lr if lr is None else lr)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """Leaves in sorted-key order, the order JAX flattens dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def from_leaves(like, flat: list):
    """``flat``, in ``leaves`` order, as a tree shaped like ``like``."""
    return _rebuild(like, iter(flat))


def _rebuild(node, it):
    # a module-level function: a recursive closure would hold the leaves in
    # a reference cycle, freed only when the garbage collector runs
    return {k: _rebuild(node[k], it) for k in sorted(node)} if isinstance(node, dict) else next(it)


def adamw_init(params, state_dtype="float32"):
    dt = getattr(torch, state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"mu": _map(zeros, params), "nu": _map(zeros, params)}


@torch.no_grad()
def adamw_update(opt: AdamW, params, state, grads, step: int, lr: float):
    """One AdamW step, in place. ``step`` counts from 0; bias correction uses
    ``step + 1``. Weight decay only where ``p.ndim >= 2`` (norms and biases
    are exempt). Returns (params, state), the trees that were passed in."""
    b1, b2 = opt.b1, opt.b2
    t = torch.tensor(float(step + 1), dtype=torch.float32)
    # 0-dim f32 tensors on the parameters' device: the quotients below are
    # then true divisions on every backend, as in the JAX version
    dev = leaves(params)[0].device
    c1 = (1.0 - torch.tensor(b1, dtype=torch.float32) ** t).to(dev)
    c2 = (1.0 - torch.tensor(b2, dtype=torch.float32) ** t).to(dev)
    dt = getattr(torch, opt.state_dtype)

    def upd(p, m, v, g):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + opt.eps)
        if p.ndim >= 2:                  # decay matrices only (norms/bias exempt)
            delta = delta + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32.to(dt))
        v.copy_(v32.to(dt))

    _map(upd, params, state["mu"], state["nu"], grads)
    return params, state


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so that their global norm is at most ``max_norm``.
    Returns (new grads, the norm before clipping)."""
    n = global_norm(grads)
    scale = torch.minimum(torch.ones_like(n),
                          torch.full_like(n, max_norm) / torch.clamp_min(n, 1e-9))
    return _map(lambda g: (g.float() * scale).to(g.dtype), grads), n
