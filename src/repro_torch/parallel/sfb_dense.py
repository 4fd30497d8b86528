"""Gradient-sync variants for data-parallel dense layers, the port of
``repro.parallel.sfb_dense``: the primitives ``allreduce_grad``, ``ps_grad``
and ``tree_grad_sync`` that per-stage data parallelism syncs with, and the
dense layer ``sfb_dense_apply`` with its MLP ``dp_mlp_loss``, which run the
paper's three strategy options for real.

One process drives every device (``exec.engine``), so a value that
``repro`` holds as one shard a device inside ``shard_map`` is here a list of
tensors, shard ``i`` on device ``i`` of the stage. Each collective is an
explicit function over that list, summed in shard order:

  * "allreduce": one sum, a copy of it on every shard (DP-NCCL analogue);
  * "ps": reduce-scatter one flat slice per owner, then all-gather
    (sharded parameter server, ZeRO round-robin owners);
  * "sfb": sufficient factor broadcasting does not sync gradients: the
    engine gathers the stage's inputs and output gradients and recomputes
    the parameter gradient on the full batch.
"""
from __future__ import annotations

import numpy as np
import torch

SYNC_MODES = ("allreduce", "ps", "sfb")


def _sum(parts: list, device) -> torch.Tensor:
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def allreduce_grad(shards: list, out: int | None = None):
    """The sum of every shard's gradient, one copy on each shard's device;
    with ``out``, only shard ``out``'s copy."""
    total = _sum(shards, shards[0].device)
    if out is not None:
        return total.to(shards[out].device)
    return [total.to(g.device) for g in shards]


def ps_grad(shards: list, n_dev: int, out: int | None = None):
    """Reduce-scatter then all-gather: flatten, pad to a multiple of
    ``n_dev``, owner ``j`` sums slice ``j`` over the shards, every shard
    gathers the owners' slices, and the padding is cut off again. Only the
    last slice reaches into the padding, so only it is padded. With
    ``out``, only shard ``out`` gathers."""
    assert len(shards) == n_dev, (len(shards), n_dev)
    g0 = shards[0]
    numel = g0.numel()
    width = -(-numel // n_dev)

    def owned(j):
        parts = [g.reshape(-1)[j * width:(j + 1) * width] for g in shards]
        short = width - parts[0].numel()
        if short:
            parts = [torch.cat([f, f.new_zeros(short)]) for f in parts]
        return _sum(parts, shards[j].device)

    slices = [owned(j) for j in range(n_dev)]

    def gather(device):
        return torch.cat([o.to(device) for o in slices])[:numel].reshape(g0.shape)

    if out is not None:
        return gather(shards[out].device)
    return [gather(g.device) for g in shards]


def tree_grad_sync(trees: list, sync: str, n_dev: int, out: int | None = None):
    """Apply one sync mode to every leaf of ``n_dev`` gradient trees (nested
    dicts of tensors, one a shard); with ``out``, only shard ``out``'s synced
    tree. ``sfb`` is absent by design: SFB moves the sufficient factors, not
    the gradients (``exec.engine``)."""
    if n_dev <= 1:
        return trees if out is None else trees[out]
    if sync == "allreduce":
        def fn(leaves):
            return allreduce_grad(leaves, out)
    elif sync == "ps":
        def fn(leaves):
            return ps_grad(leaves, n_dev, out)
    else:
        raise ValueError(f"tree_grad_sync cannot apply {sync!r} (use one of allreduce|ps)")

    def rec(nodes):
        if isinstance(nodes[0], dict):
            per = {k: rec([t[k] for t in nodes]) for k in nodes[0]}
            if out is not None:
                return per
            return [{k: v[i] for k, v in per.items()} for i in range(len(nodes))]
        return fn(nodes)
    return rec(list(trees))


def _axis_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` of ``mesh`` (index 0 of every other axis:
    ``repro``'s ``shard_map`` replicates over them)."""
    i = mesh.axis_names.index(axis)
    devs = np.moveaxis(mesh.devices, i, 0).reshape(mesh.devices.shape[i], -1)[:, 0]
    return [torch.device(d) for d in devs]


def sfb_dense_apply(mesh, axis: str, sync: str):
    """Returns ``dense(xs, w)``: ``xs`` the batch shards of ``x`` over the
    devices of ``axis`` (shard ``i`` on device ``i``), ``w`` replicated;
    returns the shards of ``x @ w``. Its backward gives each shard
    ``dy_i @ wᵀ`` and ``w`` the gradient the sync mode computes:
    ``allreduce`` and ``ps`` sum the shards' ``x_iᵀ dy_i`` through
    ``allreduce_grad`` and ``ps_grad``; ``sfb`` gathers ``x`` and ``dy`` and
    makes one product.

    ``w`` enters the forward inside the ``autograd.Function``, so its only
    gradient is the one the backward returns: the shards' copies of ``w``
    add no second sum (the redundant psum ``repro``'s ``custom_vjp`` outside
    ``shard_map`` avoids)."""
    if sync not in SYNC_MODES:
        raise ValueError(f"unknown sync mode {sync!r} (one of {SYNC_MODES})")
    n_dev = len(_axis_devices(mesh, axis))

    class _Dense(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w, *xs):
            ctx.save_for_backward(w, *xs)
            return tuple(x @ w.to(x.device) for x in xs)

        @staticmethod
        def backward(ctx, *dys):
            w, *xs = ctx.saved_tensors
            dxs = [dy @ w.to(dy.device).T for dy in dys]
            if sync == "sfb":
                dw = torch.cat([x.to(w.device) for x in xs]).T \
                    @ torch.cat([dy.to(w.device) for dy in dys])
            else:
                local = [x.T @ dy for x, dy in zip(xs, dys, strict=True)]
                dw = allreduce_grad(local, out=0) if sync == "allreduce" \
                    else ps_grad(local, n_dev, out=0)
            return (dw.to(w.device), *dxs)

    def dense(xs, w):
        return list(_Dense.apply(w, *xs))
    return dense


def dp_mlp_loss(mesh, axis: str, sync: str, widths):
    """A small data-parallel MLP whose every layer syncs its gradient by the
    chosen mode. The returned ``loss_fn(params, x, y)`` splits the rows of
    ``x`` and ``y`` over the devices of ``axis`` (their count must divide
    the batch, as ``shard_map`` requires) and returns the mean squared error
    on the first device."""
    dense = sfb_dense_apply(mesh, axis, sync)
    devices = _axis_devices(mesh, axis)

    def shards(t):
        if t.shape[0] % len(devices):
            raise ValueError(f"{len(devices)} devices do not divide a batch of {t.shape[0]}")
        return [c.to(d) for c, d in zip(t.chunk(len(devices)), devices, strict=True)]

    def loss_fn(params, x, y):
        hs = shards(x)
        for i, w in enumerate(params):
            hs = dense(hs, w)
            if i < len(params) - 1:
                hs = [torch.relu(h) for h in hs]
        sq = [((h - t) ** 2).sum().to(devices[0]) for h, t in zip(hs, shards(y), strict=True)]
        return torch.stack(sq).sum() / y.numel()
    return loss_fn


def sfb_wire_bytes(batch: int, h1: int, h2: int, d: int,
                   itemsize: int = 4) -> dict:
    """Napkin model of per-step wire bytes (ring collectives)."""
    return {
        "allreduce": 2 * (d - 1) / d * h1 * h2 * itemsize,
        "ps": 2 * (d - 1) / d * h1 * h2 * itemsize,
        "sfb": (d - 1) / d * batch * (h1 + h2) * itemsize * 2,
    }
