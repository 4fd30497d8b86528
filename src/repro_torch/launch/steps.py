"""Builders for the train, pipeline train, prefill and serve steps, and the
logical axis-rule sets that TAG strategies lower into, as
``repro.launch.steps``.

The steps run under one controller, as the pipeline engine does, over the
rules' mesh, whose positions are ``torch.device``s (which may repeat). The
mesh's positions form a grid (``parallel.tensor.layout``): a row for each
position of the rules' batch axes, a column for each position of the one
other axis with more than one position (``"model"``).

* **Data parallelism** (one column): each row gets its replica of the
  parameters and its rows of the batch, split on dim 0 where the row count
  divides it and replicated otherwise, as ``logical_spec`` decides. The
  train step averages the rows' gradients with
  ``parallel.sfb_dense.allreduce_grad`` and applies AdamW once, to the
  parameters on the first device.
* **Tensor parallelism** (more than one column), **FSDP** (a parameter
  dim on batch axes, such as ``embed=data``), or both: the steps take the
  parameters as ``parallel.tensor.shard_params`` lays them out, one tree a
  position, and a row's positions run the model split over the column axis
  as ``parallel/tensor.py`` describes, gathering the slices of a leaf split
  over the rows before the unit that reads it. The train step sums each
  shard's gradient over the rows (a whole leaf's over every position,
  a leaf split over the rows reduce-scattered), clips by the global norm
  over the distinct shards, and AdamW updates each shard in place on its
  position, its moments laid out as the parameters
  (``parallel.tensor.shard_state``).

MoE layers route as ``repro``'s do under the rules: ``repro`` groups the
global batch's tokens by the rules' batch axes (``moe.num_groups``), and
each row's tokens are that many groups over the row count where the rows
are split, all of them where they are replicated (``_local_groups``); the
aux loss takes the top-1 density of the whole batch. ``rules=None``, or a
mesh of one device, is one device: the same ops as before, no copies.

``jit_train_step``, ``jit_serve_step`` and ``jit_prefill_step`` keep
``repro``'s names, signatures and return tuples (the step and its
shardings); nothing is jitted: the step is the one ``make_*_step`` returns.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.optim.adam import (
    AdamW, clip_by_global_norm, from_leaves, global_norm, leaves)
from repro_torch.parallel import tensor as tp_mod
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
    rules' batch axes (under tensor parallelism, each row's first position);
    None for one device (no rules, or a mesh of one). Raises
    NotImplementedError where the rules split a parameter dim over a mesh
    axis the step cannot split (``parallel.tensor.layout``)."""
    lay = tp_mod.layout(cfg, rules)
    return None if lay is None else list(lay.grid[:, 0])


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
    autograd, over the rules' rows (module docstring). The loss and
    ``metrics`` (``ce``, ``aux``) are means over the rows, which is the
    global-batch mean: ``loss_fn`` is an unmasked mean over equal rows. Under
    data parallelism ``grads`` lie on the parameters' device; where the
    rules split parameters (tensor parallelism, FSDP) ``params`` and
    ``grads`` are one tree a position (``parallel.tensor.shard_params``).

    Under MoE, every row's forward runs before any backward: each MoE
    layer's aux loss, E sum_e density_e mean_probs_e, takes the density (a
    top-1 share, no gradient) of the whole batch, the mean of the rows'
    (``loss_fn``'s ``"moe"`` stats), so that the mean of the rows' aux is
    ``repro``'s aux over the batch, gradient and all. A dense model has no
    density to wait for: each row's backward follows its forward, so that
    one autograd graph is held at a time."""
    options = options if options is not None else StepOptions()
    lay = tp_mod.layout(cfg, rules)
    opts = {"remat": options.remat, "loss_chunk": options.loss_chunk,
            "remat_policy": options.remat_policy}

    def loss_of(params, batch):
        return model_mod.loss_fn(cfg, params, batch, **opts)

    def one_device(params, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with torch.profiler.record_function("train/loss"):
            loss, metrics = loss_of(params, batch)
        with torch.profiler.record_function("train/backward"):
            grads = from_leaves(params, torch.autograd.grad(loss, ps))
        return loss.detach(), {k: metrics[k].detach() for k in ("ce", "aux")}, grads

    def over_rows(batch, run, dev):
        """Each row's ``run(i, rows of the batch) -> (autograd leaves,
        loss_fn's metrics)`` and its backward: (loss, metrics, each row's
        gradients of its leaves)."""
        homes = list(lay.grid[:, 0])
        groups = _local_groups(rules, homes, batch)

        def backward(i, ps, metrics, density):
            d = homes[i]
            aux = torch.zeros((), dtype=torch.float32, device=d)
            with tp_mod.at(i):
                for dens, (_, mean_probs) in zip(density, metrics["moe"], strict=True):
                    aux = aux + moe_mod.aux_loss(dens.to(d), mean_probs)
                loss = metrics["ce"] + model_mod.MAX_SMOKE_AUX * aux
                with torch.profiler.record_function("train/backward"):
                    grads = torch.autograd.grad(loss, ps, allow_unused=True)
            # a leaf no program of the row read (a whole head the row's
            # first position alone applies) has a zero gradient
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, ps, strict=True)]
            return grads, loss.detach().to(dev), {"ce": metrics["ce"].detach().to(dev),
                                                  "aux": aux.detach().to(dev)}

        pending, done = [], []
        for i, mb in enumerate(_scatter(rules, homes, batch)):
            with torch.profiler.record_function("train/loss"), moe_mod.routing(groups), \
                    tp_mod.at(i):
                ps, metrics = run(i, mb)
            if metrics["moe"]:
                pending.append((i, ps, metrics))
            else:
                done.append(backward(i, ps, metrics, ()))
        density = [torch.stack([dens.to(dev) for dens, _ in layer]).mean(0)
                   for layer in zip(*(m["moe"] for _, _, m in pending))]
        while pending:
            done.append(backward(*pending.pop(0), density))
        loss = torch.stack([lo for _, lo, _ in done]).mean()
        metrics = {k: torch.stack([m[k] for _, _, m in done]).mean() for k in ("ce", "aux")}
        return loss, metrics, [g for g, _, _ in done]

    def data_parallel(params, batch):
        dev = leaves(params)[0].device
        homes = list(lay.grid[:, 0])

        def run(i, mb):
            ps = [t.detach().to(homes[i]).requires_grad_(True) for t in leaves(params)]
            return ps, loss_of(from_leaves(params, ps), mb)[1]
        loss, metrics, rows = over_rows(batch, run, dev)
        with torch.profiler.record_function("train/allreduce"):
            grads = [tp_mod.all_reduce(list(parts), range(len(rows)), out=0).to(dev) / len(rows)
                     for parts in zip(*rows, strict=True)]
        return loss, metrics, from_leaves(params, grads)

    def sharded(shards, batch):
        tp_mod.check_shards(lay, shards)
        rows = lay.rows()
        # one autograd leaf a position's leaf, read by every row that
        # gathers it
        flat = [[t.detach().requires_grad_(True) for t in leaves(tr)] for tr in shards]
        trees = [from_leaves(tr, f) for tr, f in zip(shards, flat, strict=True)]

        def run(i, mb):
            _, metrics = tp_mod.loss_row(lay, rows[i], tp_mod.row_params(lay, trees, rows[i]),
                                         mb, **opts)
            return [flat[p][k] for p, k in tp_mod.row_reads(lay, i)], metrics
        loss, metrics, by_row = over_rows(batch, run, lay.grid[0, 0])
        with torch.profiler.record_function("train/allreduce"):
            grads = tp_mod.sync_grads(lay, by_row, shards, 1.0 / lay.n)
        return loss, metrics, grads

    if lay is None:
        return one_device
    return sharded if lay.sharded else data_parallel


def make_train_step(cfg: ModelConfig, opt: AdamW, rules: AxisRules | None,
                    options: StepOptions | None = None):
    """(params, opt_state, step, batch) -> (params, opt_state, metrics): the
    loss and its gradient (``make_grad_step``, over the rules' rows),
    clipping by the global norm and an AdamW update, which writes into
    ``params`` and ``opt_state`` on their devices. ``metrics`` holds 0-dim
    tensors ``loss``, ``ce``, ``aux`` and ``grad_norm``. Where the rules
    split parameters ``params`` is ``parallel.tensor.shard_params``'s list
    and ``opt_state`` ``parallel.tensor.shard_state``'s.

    The phases run under ``torch.profiler.record_function`` ranges
    (``train/loss``, ``train/backward``, ``train/allreduce`` over several
    rows or positions, ``train/clip``, ``train/optimizer``), so that a
    profile can split the step's device time by phase."""
    options = options if options is not None else StepOptions()
    grad_step = make_grad_step(cfg, rules, options)
    lay = tp_mod.layout(cfg, rules)
    sharded = lay is not None and lay.sharded

    def train_step(params, opt_state, step: int, batch):
        loss, metrics, grads = grad_step(params, batch)
        with torch.profiler.record_function("train/clip"):
            if sharded:
                grads, gnorm = tp_mod.clip_by_global_norm(lay, grads, options.clip_norm)
            else:
                grads, gnorm = clip_by_global_norm(grads, options.clip_norm)
        with torch.profiler.record_function("train/optimizer"):
            if sharded:
                params, opt_state = tp_mod.adamw_update(lay, opt, params, opt_state, grads, step)
            else:
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
    (the first position's) device; over the rules' rows, each row prefills
    its rows of the batch (MoE layers in ``_local_groups``), split over its
    positions where the rules split parameters (``params`` then
    ``parallel.tensor.shard_params``'s list)."""
    lay = tp_mod.layout(cfg, rules)

    def prefill(params, batch):
        if lay is None:
            return model_mod.prefill_step(cfg, params, batch)
        homes = list(lay.grid[:, 0])
        rows = _scatter(rules, homes, batch)
        with moe_mod.routing(_local_groups(rules, homes, batch)):
            if lay.sharded:
                tp_mod.check_shards(lay, params)
            outs = []
            for row, mb in zip(lay.rows(), rows, strict=True):
                with tp_mod.at(row.i):
                    outs.append(tp_mod.prefill_row(lay, row, tp_mod.row_params(lay, params, row), mb)
                                if lay.sharded else
                                model_mod.prefill_step(cfg, _replica(params, row.devices[0]), mb))
        return _gather(rules, outs, batch["tokens"]).to(homes[0])
    return prefill


def make_serve_step(cfg: ModelConfig, rules: AxisRules | None):
    """One decode step: (params, cache, tokens (B, 1), pos) -> greedy next
    token (B, 1) and the cache, updated in place. Over the rules' rows
    ``cache`` is a list, one cache a row holding that row's rows of the
    batch (``cache_shardings``), and each row decodes them (MoE layers in
    ``_local_groups``); the tokens come back on the first device in row
    order. Where the rules split parameters ``params`` is
    ``parallel.tensor.shard_params``'s list and ``cache`` one cache a
    position (``parallel.tensor.init_cache_shards``)."""
    lay = tp_mod.layout(cfg, rules)

    def one(params, cache, tokens, pos):
        logits, cache = model_mod.decode_step(cfg, params, cache, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    def serve(params, cache, tokens, pos: int):
        if lay is None:
            return one(params, cache, tokens, pos)
        homes = list(lay.grid[:, 0])
        shards = _scatter(rules, homes, {"tokens": tokens})
        with moe_mod.routing(_local_groups(rules, homes, {"tokens": tokens})):
            if lay.sharded:
                tp_mod.check_shards(lay, params)
            nxt = []
            for row, mb in zip(lay.rows(), shards, strict=True):
                with tp_mod.at(row.i):
                    if not lay.sharded:
                        nxt.append(one(_replica(params, row.devices[0]), cache[row.i],
                                       mb["tokens"], pos)[0])
                        continue
                    logits = tp_mod.decode_row(
                        lay, row, tp_mod.row_params(lay, params, row),
                        [cache[p] for p in row.positions], mb["tokens"], pos)
                    nxt.append(torch.argmax(logits[:, -1], dim=-1)[:, None])
        return _gather(rules, nxt, tokens).to(homes[0]), cache
    return serve


def jit_train_step(cfg, opt, rules, shape, options: StepOptions | None = None):
    """``repro``'s signature and return tuple: (train step, parameter
    shardings, optimizer-state shardings ``{"mu": ps, "nu": ps}``, batch
    shardings). The step is ``make_train_step``'s: nothing is compiled."""
    options = options if options is not None else StepOptions()
    ps = param_shardings(cfg, rules)
    return (make_train_step(cfg, opt, rules, options), ps, {"mu": ps, "nu": ps},
            batch_shardings(cfg, shape, rules))


def jit_serve_step(cfg, rules, shape):
    """(serve step, parameter, cache and batch shardings), as ``repro``'s."""
    return (make_serve_step(cfg, rules), param_shardings(cfg, rules),
            cache_shardings(cfg, shape, rules), batch_shardings(cfg, shape, rules))


def jit_prefill_step(cfg, rules, shape):
    """(prefill step, parameter shardings, None, batch shardings), as
    ``repro``'s."""
    return (make_prefill_step(cfg, rules), param_shardings(cfg, rules), None,
            batch_shardings(cfg, shape, rules))
