"""Builders for the train, pipeline train, prefill and serve steps, as
``repro.launch.steps``. No axis rules: single-mesh data parallelism is
ROADMAP queue 1, item 2.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.optim.adam import (
    AdamW, clip_by_global_norm, from_leaves, global_norm, leaves)


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


def make_train_step(cfg: ModelConfig, opt: AdamW, options: StepOptions | None = None):
    """(params, opt_state, step, batch) -> (params, opt_state, metrics): the
    loss, its gradient by autograd, clipping by the global norm and an AdamW
    update, which writes into ``params`` and ``opt_state``. ``metrics`` holds
    0-dim tensors ``loss``, ``ce``, ``aux`` and ``grad_norm``.

    The phases run under ``torch.profiler.record_function`` ranges
    (``train/loss``, ``train/backward``, ``train/clip``, ``train/optimizer``),
    so that a profile can split the step's device time by phase."""
    options = options if options is not None else StepOptions()

    def train_step(params, opt_state, step: int, batch):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with torch.profiler.record_function("train/loss"):
            loss, metrics = model_mod.loss_fn(
                cfg, params, batch, remat=options.remat, loss_chunk=options.loss_chunk,
                remat_policy=options.remat_policy)
        with torch.profiler.record_function("train/backward"):
            grads = from_leaves(params, torch.autograd.grad(loss, ps))
        with torch.profiler.record_function("train/clip"):
            grads, gnorm = clip_by_global_norm(grads, options.clip_norm)
        with torch.profiler.record_function("train/optimizer"):
            params, opt_state = opt.update(params, opt_state, grads, step)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)
    return train_step


def make_pipeline_train_step(opt: AdamW, runner, options: StepOptions | None = None):
    """Train step of the pipeline engine: ``runner.step() -> (grads_list,
    StepStats)`` with per-stage parameter and optimizer-state lists on the
    stages' devices. Clipping is by the global norm across stages: each
    stage's sum of squares, reduced on the host as a multi-host trainer's
    scalar allreduce would. The gradients are scaled in f32, cast back to
    their dtype, and AdamW updates each stage in place.

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


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits (B, 1, V)."""
    def prefill(params, batch):
        return model_mod.prefill_step(cfg, params, batch)
    return prefill


def make_serve_step(cfg: ModelConfig):
    """One decode step: (params, cache, tokens (B, 1), pos) -> greedy next
    token (B, 1) and the cache, updated in place."""
    def serve(params, cache, tokens, pos: int):
        logits, cache = model_mod.decode_step(cfg, params, cache, tokens, pos)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache
    return serve
