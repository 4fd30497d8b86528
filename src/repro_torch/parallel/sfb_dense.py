"""Gradient-sync primitives for per-stage data parallelism, the port of
``repro.parallel.sfb_dense``'s ``SYNC_MODES``, ``allreduce_grad``,
``ps_grad`` and ``tree_grad_sync``.

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
