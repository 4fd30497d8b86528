"""End-to-end training driver on one device, the single-device loop of
``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --steps 20 --batch 8 --seq 128 [--device cpu]

Synthetic data pipeline -> train step (loss, backward, clip, AdamW) ->
checkpoints -> metrics log. Runs on the card unless ``--device cpu``.
``--tag-search`` first runs the TAG strategy search on a reduced trace of
the model over an H100 cluster (``core.device.h100_nodes``) and prints the
lowered plan. A plan that pipelines falls back, with a warning, to the
single-device path when the run has fewer devices than stages; running the
pipeline itself, and ``repro``'s engine and tracing flags, are refused,
each naming the ROADMAP item (queue 1) that brings it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.optim.adam import AdamW

PIPELINE_ITEM = "1.5, pipeline engines"
# flag -> (argparse keywords, the ROADMAP item, queue 1, that brings it)
UNPORTED_FLAGS = {
    "--engine": ({}, PIPELINE_ITEM),
    "--scan-unroll": ({}, PIPELINE_ITEM),
    "--n-chunks": ({}, PIPELINE_ITEM),
    "--trace-dir": ({}, "1.7, measurement and observability"),
    "--spool-dir": ({}, "1.7, measurement and observability"),
    "--run-id": ({}, "1.7, measurement and observability"),
    "--xla-profile": ({"action": "store_true"}, "1.7, measurement and observability"),
}


def resolve_pipeline(plan, mode: str, devices) -> None:
    """Decide whether a lowered TAG plan's PIPE stages can really run on
    ``devices``, emitting an explicit log line either way, so a strategy
    with PIPE actions is never silently degraded. Returns None for the
    single-device path; where ``repro`` would run its pipeline engine this
    raises, since the engines are not ported yet."""
    sp = plan.stage_plan
    if sp is None:
        if plan.summary.get("options", {}).get("PIPE"):
            print("TAG pipeline: strategy has PIPE actions but no "
                  "multi-group pipeline spine; using single-mesh axis "
                  "rules", flush=True)
        return None
    if mode == "off":
        print(f"TAG pipeline: --pipeline off; degrading {sp.n_stages}-stage "
              f"plan to single-mesh axis rules", flush=True)
        return None
    from repro_torch.exec.stages import PipelineInfeasible
    try:
        sp.assign_local_devices(devices)
    except PipelineInfeasible as e:
        print(f"WARNING: TAG pipeline fallback — {e}; degrading to "
              f"single-mesh DP axis rules", flush=True)
        return None
    sched = sp.schedule if mode == "auto" else mode
    raise NotImplementedError(
        f"running the {sp.n_stages}-stage TAG plan (schedule={sched}) needs a "
        f"pipeline engine, not ported yet (ROADMAP queue 1, item {PIPELINE_ITEM})")


def plan_deployment(arch: str, device, n_micro: int = 4):
    """TAG search for ``arch``, as ``repro.launch.train --tag-search`` runs
    it: trace the reduced config's loss at batch 4 x seq 32, search 24
    playouts over 24 op groups on ``h100_nodes()``, lower the best strategy.
    Returns (TAGResult, ExecutionPlan)."""
    from repro_torch.core import tag as tag_mod
    from repro_torch.core.device import h100_nodes
    from repro_torch.core.plan import lower_strategy
    from repro_torch.models.model import loss_fn

    red = dataclasses.replace(get_reduced(arch), attn_impl="jnp")
    rp = init_params(red, torch.Generator(device=device).manual_seed(0), device)
    ds0 = SyntheticDataset(red.vocab_size, 32, 4,
                           frontend_tokens=red.frontend_tokens if red.frontend != "none" else 0,
                           d_model=red.d_model)
    rb = ds0.device_batch(0, device)
    topo = h100_nodes()
    result = tag_mod.optimize(lambda p, b: loss_fn(red, p, b, remat=False)[0],
                              rp, rb, topo, name=arch, iterations=24, n_groups=24)
    return result, lower_strategy(result.strategy, result.gg, topo, n_micro=n_micro)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--telemetry-dir", default="",
                    help="record per-step telemetry to this measurement log")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tag-search", action="store_true",
                    help="run TAG strategy search and apply its plan")
    ap.add_argument("--pipeline", choices=["auto", "off", "gpipe", "1f1b", "interleaved", "zb"],
                    default="auto",
                    help="how to execute PIPE actions in a TAG plan: auto uses the schedule "
                         "the searched strategy voted for, off forces single-device rules, "
                         "a schedule name asks for that schedule")
    ap.add_argument("--n-micro", type=int, default=4, help="microbatches per pipelined step")
    for flag, (kw, _) in UNPORTED_FLAGS.items():
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS, **kw)
    args = ap.parse_args(argv)
    for flag, (_, item) in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1, item {item})")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)

    if args.tag_search:
        t0 = time.perf_counter()
        result, plan = plan_deployment(args.arch, device, n_micro=args.n_micro)
        print(f"TAG search: {len(result.gg.base.nodes)} ops in {result.gg.n} groups, "
              f"simulated {result.time:.6g} s vs DP-AllReduce {result.baseline_time:.6g} s, "
              f"{len(result.sfb_plans)} SFB duplications, {time.perf_counter() - t0:.2f} s",
              flush=True)
        print(f"TAG plan: speedup={result.speedup:.2f}x "
              f"summary={json.dumps(plan.summary)}", flush=True)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        resolve_pipeline(plan, args.pipeline, devices)
    opt = AdamW(lr=args.lr)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt_state = opt.init(params)
    start_step = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start_step, tree = load_checkpoint(args.ckpt_dir, device=device)
        if "stage0" in tree.get("params", {}):
            raise ValueError(
                f"checkpoint in {args.ckpt_dir} is a per-stage pipeline checkpoint; "
                f"pipelines are not ported yet (ROADMAP queue 1, item 1.5)")
        params, opt_state = tree["params"], tree["opt_state"]
        print(f"resumed from step {start_step}", flush=True)

    ds = SyntheticDataset(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                          frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
                          d_model=cfg.d_model)
    options = steps_mod.StepOptions(loss_chunk=args.loss_chunk)
    step_fn = steps_mod.make_train_step(cfg, opt, options)
    timer = None
    if args.telemetry_dir:
        from repro_torch.runtime.telemetry import MeasurementStore, StepTimer
        timer = StepTimer(MeasurementStore(args.telemetry_dir),
                          meta={"arch": args.arch, "batch": args.batch, "seq": args.seq,
                                "launcher": "train", "run_id": f"train-{args.arch}",
                                "device": str(device)})
        step_fn = steps_mod.instrument_step(step_fn, timer)

    print(f"training {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on {device}",
          flush=True)
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = ds.device_batch(step, device)
        params, opt_state, metrics = step_fn(params, opt_state, step, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss={loss:.4f} ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt_state": opt_state})
    dt = time.time() - t_start
    n = max(args.steps - start_step, 1)
    tail = f"; loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else ""
    print(f"done: {n} steps in {dt:.1f}s ({dt / n * 1e3:.0f} ms/step){tail}", flush=True)
    if timer is not None:
        print(f"telemetry[{args.telemetry_dir}]: {json.dumps(timer.summary())}", flush=True)
    return losses


if __name__ == "__main__":
    main()
