"""Builders for the train, pipeline train, prefill and serve steps, and the
logical axis-rule sets that TAG strategies lower into, as
``repro.launch.steps``.

Single-mesh data parallelism runs under one controller, as the pipeline
engine does: where the rules' batch axes span ``n > 1`` positions of the
mesh, a step hands each position (a ``torch.device``, which may repeat)
its replica of the parameters and its rows of the batch, split on dim 0
where ``n`` divides it and replicated otherwise, as ``logical_spec``
decides. MoE layers route as ``repro``'s do under the rules: ``repro``
groups the global batch's tokens by the rules' batch axes
(``moe.num_groups``), and each device's rows are that many groups over the
device count where the rows are split, all of them where they are
replicated (``_local_groups``); the aux loss takes the top-1 density of the
whole batch. The train step averages the per-shard gradients with
``parallel.sfb_dense.allreduce_grad`` and applies AdamW once, to the
parameters on the first device. Rules that shard a parameter dim (a
``"model"`` axis of size > 1) are tensor parallelism, ROADMAP queue 1,
item 10. ``rules=None``, or a mesh of one device, is one device: the same
ops as before, no copies. ``repro``'s ``jit_*_step`` builders wait for the
dry run (item 10).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.optim.adam import (
    AdamW, clip_by_global_norm, from_leaves, global_norm, leaves)
from repro_torch.parallel.sfb_dense import allreduce_grad
from repro_torch.parallel.sharding import (
    AxisRules, NamedSharding, axis_rules, logical_spec)


def baseline_rules(mesh, *, overrides: dict | None = None,
                   grad_sync: dict | None = None) -> AxisRules:
    """Paper-faithful DP(+TP) baseline: batch over pod+data, tensor dims over
    model. TAG strategies produce ``overrides``/``grad_sync`` on top."""
    multi = "pod" in mesh.axis_names
    rules = {
        "batch": ("pod", "data") if multi else ("data",),
        "cache_seq": ("data",),
        "q_heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "embed": None,
        "expert_embed": None,
        "layers": None,
        "seq": None,
    }
    if overrides:
        rules.update(overrides)
    return AxisRules(mesh=mesh, rules=rules, grad_sync=dict(grad_sync or {}))


def _specs(rules: AxisRules, axes, shapes):
    """``NamedSharding`` tree of ``axes`` (a tree of logical-axis tuples)
    over the matching tree of tensors ``shapes``."""
    if isinstance(axes, dict):
        return {k: _specs(rules, axes[k], shapes[k]) for k in axes}
    with axis_rules(rules):
        return NamedSharding(rules.mesh, logical_spec(axes, shape=tuple(shapes.shape)))


def param_shardings(cfg: ModelConfig, rules: AxisRules):
    """NamedSharding tree matching ``abstract_params(cfg)``."""
    return _specs(rules, model_mod.param_axes(cfg), model_mod.abstract_params(cfg))


def batch_shardings(cfg: ModelConfig, shape: InputShape, rules: AxisRules) -> dict:
    specs = model_mod.input_specs(cfg, shape)
    return {k: _specs(rules, ("batch",) + (None,) * (v.dim() - 1), v)
            for k, v in specs.items()}


def cache_shardings(cfg: ModelConfig, shape: InputShape, rules: AxisRules):
    return _specs(rules, model_mod.cache_axes(cfg),
                  model_mod.cache_specs(cfg, shape.global_batch, shape.seq_len))


def data_devices(cfg: ModelConfig, rules: AxisRules | None) -> list | None:
    """The devices a step spreads the batch over, in the order of the
    rules' batch axes; None for one device (no rules, or a mesh of one).
    Raises NotImplementedError where the rules shard a parameter dim or a
    mesh axis outside the batch axes has more than one position."""
    if rules is not None and not isinstance(rules, AxisRules):
        raise TypeError(f"rules must be AxisRules or None, got {type(rules).__name__}")
    if rules is None or rules.mesh is None or rules.mesh.size == 1:
        return None
    mesh = rules.mesh
    sharded = [s.spec for s in leaves(param_shardings(cfg, rules))
               if any(e is not None and rules.axis_size(e) > 1 for e in s.spec)]
    ax = rules.mesh_axes("batch") or ()
    ax = (ax,) if isinstance(ax, str) else tuple(ax)
    rest = [a for a in mesh.axis_names if a not in ax]
    if sharded or any(mesh.shape[a] > 1 for a in rest):
        raise NotImplementedError(
            f"rules over {mesh.shape} shard the parameters ({sharded[:2]}...) or replicate "
            f"over a non-batch axis: tensor parallelism is not ported yet (ROADMAP queue 1, "
            f"item 10)")
    order = [mesh.axis_names.index(a) for a in (*ax, *rest)]
    return list(np.transpose(mesh.devices, order).flat)


def _rows_split(rules: AxisRules, t: torch.Tensor) -> bool:
    """Whether ``logical_spec`` splits a batch-leading leaf's dim 0."""
    with axis_rules(rules):
        return bool(logical_spec(("batch",) + (None,) * (t.dim() - 1), tuple(t.shape)))


def _scatter(rules, devices: list, tree: dict) -> list:
    """A batch-leading dict as one dict a device: each leaf split on dim 0
    where the batch axes divide it, else replicated."""
    n = len(devices)

    def shard(t, i):
        if _rows_split(rules, t):
            w = t.shape[0] // n
            t = t[i * w:(i + 1) * w]
        return t.to(devices[i])
    return [{k: shard(v, i) for k, v in tree.items()} for i in range(n)]


def _local_groups(rules, devices: list, batch: dict) -> int:
    """The MoE group count of one device's rows: ``repro``'s count over the
    global batch (every token of ``batch``, the prefix included) under the
    rules, over the number of row shards."""
    tokens = batch["tokens"]
    T = tokens.numel() + (batch["prefix"].shape[0] * batch["prefix"].shape[1]
                          if "prefix" in batch else 0)
    with axis_rules(rules):
        G = moe_mod.num_groups(T)
    return G // len(devices) if _rows_split(rules, tokens) else G


def _gather(rules, shards: list, like: torch.Tensor) -> torch.Tensor:
    """One device's shards back as one tensor on the first device: rows
    concatenated in device order where ``like`` (the full-batch input)
    was split, shard 0's where it was replicated."""
    dev = shards[0].device
    if _rows_split(rules, like):
        return torch.cat([s.to(dev) for s in shards])
    return shards[0]


def _replica(tree, device):
    """``tree`` on ``device``; on the device it lives on, the same tensors."""
    if isinstance(tree, dict):
        return {k: _replica(v, device) for k, v in tree.items()}
    return tree.to(device)


def instrument_step(step_fn, timer):
    """Telemetry seam for the step builders: wrap a step with a
    ``runtime.telemetry.StepTimer``."""
    return timer.wrap(step_fn)


@dataclass(frozen=True)
class StepOptions:
    remat: bool = True
    loss_chunk: int = 0
    clip_norm: float = 1.0
    remat_policy: str = "full"


def make_grad_step(cfg: ModelConfig, rules: AxisRules | None,
                   options: StepOptions | None = None):
    """(params, batch) -> (loss, metrics, grads): the loss and its gradient by
    autograd, over the rules' data-parallel devices (module docstring). The
    loss and ``metrics`` (``ce``, ``aux``) are means over the shards, which
    is the global-batch mean: ``loss_fn`` is an unmasked mean over equal
    shards. ``grads`` lie on the parameters' device.

    Under MoE, every shard's forward runs before any backward: each MoE
    layer's aux loss, E sum_e density_e mean_probs_e, takes the density (a
    top-1 share, no gradient) of the whole batch, the mean of the shards'
    (``loss_fn``'s ``"moe"`` stats), so that the mean of the shards' aux is
    ``repro``'s aux over the batch, gradient and all. A dense model has no
    density to wait for: each shard's backward follows its forward, so that
    one autograd graph is held at a time."""
    options = options if options is not None else StepOptions()
    devices = data_devices(cfg, rules)

    def loss_of(params, batch):
        return model_mod.loss_fn(cfg, params, batch, remat=options.remat,
                                 loss_chunk=options.loss_chunk,
                                 remat_policy=options.remat_policy)

    def one_device(params, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with torch.profiler.record_function("train/loss"):
            loss, metrics = loss_of(params, batch)
        with torch.profiler.record_function("train/backward"):
            grads = from_leaves(params, torch.autograd.grad(loss, ps))
        return loss.detach(), {k: metrics[k].detach() for k in ("ce", "aux")}, grads

    def data_parallel(params, batch):
        dev = leaves(params)[0].device
        n = len(devices)
        groups = _local_groups(rules, devices, batch)

        def backward(ps, metrics, density):
            d = ps[0].device
            aux = torch.zeros((), dtype=torch.float32, device=d)
            for dens, (_, mean_probs) in zip(density, metrics["moe"], strict=True):
                aux = aux + moe_mod.aux_loss(dens.to(d), mean_probs)
            loss = metrics["ce"] + model_mod.MAX_SMOKE_AUX * aux
            with torch.profiler.record_function("train/backward"):
                grads = torch.autograd.grad(loss, ps)
            return grads, loss.detach().to(dev), {"ce": metrics["ce"].detach().to(dev),
                                                  "aux": aux.detach().to(dev)}

        pending, done = [], []
        for d, mb in zip(devices, _scatter(rules, devices, batch), strict=True):
            ps = [t.detach().to(d).requires_grad_(True) for t in leaves(params)]
            with torch.profiler.record_function("train/loss"), moe_mod.routing(groups):
                _, metrics = loss_of(from_leaves(params, ps), mb)
            if metrics["moe"]:
                pending.append((ps, metrics))
            else:
                done.append(backward(ps, metrics, ()))
        density = [torch.stack([dens.to(dev) for dens, _ in layer]).mean(0)
                   for layer in zip(*(m["moe"] for _, m in pending))]
        while pending:
            done.append(backward(*pending.pop(0), density))
        del ps, metrics
        with torch.profiler.record_function("train/allreduce"):
            grads = [allreduce_grad(list(parts), out=0).to(dev) / n
                     for parts in zip(*(g for g, _, _ in done), strict=True)]
        loss = torch.stack([lo for _, lo, _ in done]).mean()
        metrics = {k: torch.stack([m[k] for _, _, m in done]).mean() for k in ("ce", "aux")}
        return loss, metrics, from_leaves(params, grads)

    return one_device if devices is None else data_parallel


def make_train_step(cfg: ModelConfig, opt: AdamW, rules: AxisRules | None,
                    options: StepOptions | None = None):
    """(params, opt_state, step, batch) -> (params, opt_state, metrics): the
    loss and its gradient (``make_grad_step``, over the rules' data-parallel
    devices), clipping by the global norm and an AdamW update, which writes
    into ``params`` and ``opt_state`` on their device. ``metrics`` holds
    0-dim tensors ``loss``, ``ce``, ``aux`` and ``grad_norm``.

    The phases run under ``torch.profiler.record_function`` ranges
    (``train/loss``, ``train/backward``, ``train/allreduce`` under data
    parallelism, ``train/clip``, ``train/optimizer``), so that a profile can
    split the step's device time by phase."""
    options = options if options is not None else StepOptions()
    grad_step = make_grad_step(cfg, rules, options)

    def train_step(params, opt_state, step: int, batch):
        loss, metrics, grads = grad_step(params, batch)
        with torch.profiler.record_function("train/clip"):
            grads, gnorm = clip_by_global_norm(grads, options.clip_norm)
        with torch.profiler.record_function("train/optimizer"):
            params, opt_state = opt.update(params, opt_state, grads, step)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)
    return train_step


def make_pipeline_train_step(opt: AdamW, runner, options: StepOptions | None = None):
    """Train step of the pipeline engines: ``runner`` is an
    ``exec.engine.PipelineRunner`` or ``CompiledPipelineRunner``, whose
    ``step() -> (grads_list, StepStats)`` works on per-stage parameter and
    optimizer-state lists on the stages' devices. Clipping is by the global
    norm across stages: each stage's sum of squares, reduced on the host as
    a multi-host trainer's scalar allreduce would. The gradients are scaled
    in f32, cast back to their dtype, and AdamW updates each stage in place
    (the compiled engine's graphs read the parameters where they lie).

    (params_list, opt_state_list, step, batch, record=False) ->
    (params_list, opt_state_list, metrics) with float metrics ``loss``,
    ``ce``, ``aux``, ``grad_norm``, ``wall_time`` and ``peak_stash``. The
    phases run under ``train/pipeline``, ``train/clip`` and
    ``train/optimizer`` profiler ranges, as ``make_train_step``'s do."""
    options = options if options is not None else StepOptions()

    def step_fn(params_list, opt_state_list, step: int, batch, *, record: bool = False):
        with torch.profiler.record_function("train/pipeline"):
            grads, stats = runner.step(params_list, batch, record=record)
        with torch.profiler.record_function("train/clip"):
            gnorm = float(sum(float(global_norm(g) ** 2) for g in grads)) ** 0.5
            scale = min(1.0, options.clip_norm / max(gnorm, 1e-9))
        new_p, new_s = [], []
        with torch.profiler.record_function("train/optimizer"):
            for p, s, g in zip(params_list, opt_state_list, grads, strict=True):
                sc = torch.tensor(scale, dtype=torch.float32, device=leaves(p)[0].device)
                g = from_leaves(g, [(x.float() * sc).to(x.dtype) for x in leaves(g)])
                p2, s2 = opt.update(p, s, g, step)
                new_p.append(p2)
                new_s.append(s2)
        metrics = dict(stats.metrics, loss=stats.loss, grad_norm=gnorm,
                       wall_time=stats.wall_time, peak_stash=stats.peak_stash)
        return new_p, new_s, metrics
    return step_fn


def make_prefill_step(cfg: ModelConfig, rules: AxisRules | None):
    """(params, batch) -> last-position logits (B, 1, V) on the parameters'
    device; over the rules' data-parallel devices, each device prefills its
    rows (MoE layers in ``_local_groups``)."""
    devices = data_devices(cfg, rules)

    def prefill(params, batch):
        if devices is None:
            return model_mod.prefill_step(cfg, params, batch)
        with moe_mod.routing(_local_groups(rules, devices, batch)):
            outs = [model_mod.prefill_step(cfg, _replica(params, d), mb)
                    for d, mb in zip(devices, _scatter(rules, devices, batch), strict=True)]
        return _gather(rules, outs, batch["tokens"]).to(leaves(params)[0].device)
    return prefill


def make_serve_step(cfg: ModelConfig, rules: AxisRules | None):
    """One decode step: (params, cache, tokens (B, 1), pos) -> greedy next
    token (B, 1) and the cache, updated in place. Over the rules'
    data-parallel devices ``cache`` is a list, one cache a device holding
    that device's rows (``cache_shardings``), and each device decodes its
    rows (MoE layers in ``_local_groups``); the tokens come back on the
    parameters' device in device order."""
    devices = data_devices(cfg, rules)

    def one(params, cache, tokens, pos):
        logits, cache = model_mod.decode_step(cfg, params, cache, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    def serve(params, cache, tokens, pos: int):
        if devices is None:
            return one(params, cache, tokens, pos)
        shards = _scatter(rules, devices, {"tokens": tokens})
        with moe_mod.routing(_local_groups(rules, devices, {"tokens": tokens})):
            nxt = [one(_replica(params, d), c, mb["tokens"], pos)[0]
                   for d, c, mb in zip(devices, cache, shards, strict=True)]
        return _gather(rules, nxt, tokens).to(leaves(params)[0].device), cache
    return serve
