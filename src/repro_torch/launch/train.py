"""End-to-end training driver on one device, the single-device loop of
``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --steps 20 --batch 8 --seq 128 [--device cpu]

Synthetic data pipeline -> train step (loss, backward, clip, AdamW) ->
checkpoints -> metrics log. Runs on the card unless ``--device cpu``.
``repro``'s flags for strategy search, pipelines and tracing are accepted by
name and refused, each naming the ROADMAP item (queue 1) that brings it.
"""
from __future__ import annotations

import argparse
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

# flag -> (argparse keywords, the ROADMAP item, queue 1, that brings it)
UNPORTED_FLAGS = {
    "--tag-search": ({"action": "store_true"}, "1.4, planner copy + --tag-search"),
    "--pipeline": ({}, "1.5, pipeline engines"),
    "--engine": ({}, "1.5, pipeline engines"),
    "--scan-unroll": ({}, "1.5, pipeline engines"),
    "--n-micro": ({}, "1.5, pipeline engines"),
    "--n-chunks": ({}, "1.5, pipeline engines"),
    "--trace-dir": ({}, "1.7, measurement and observability"),
    "--spool-dir": ({}, "1.7, measurement and observability"),
    "--run-id": ({}, "1.7, measurement and observability"),
    "--xla-profile": ({"action": "store_true"}, "1.7, measurement and observability"),
}


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
    for flag, (kw, _) in UNPORTED_FLAGS.items():
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS, **kw)
    args = ap.parse_args(argv)
    for flag, (_, item) in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1, item {item})")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
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
