"""End-to-end training driver, the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --steps 20 --batch 8 --seq 128 [--device cpu]

Synthetic data pipeline -> train step (loss, backward, clip, AdamW) ->
checkpoints -> metrics log. Runs on the card unless ``--device cpu``.
``--tag-search`` first runs the TAG strategy search on a reduced trace of
the model over an H100 cluster (``core.device.h100_nodes``) and prints the
lowered plan. A plan that pipelines runs through a pipeline engine
(``run_pipeline``: ``--engine eager`` dispatches every schedule event,
``--engine scan`` runs each stage's loops as CUDA graphs) where the run has
at least as many devices as stages, and otherwise falls back, with a
warning, to single-mesh data parallelism over the host mesh, which is also
the path without ``--tag-search``. ``--trace-dir`` writes Chrome traces of the
planner's spans and of the last pipelined step, ``--spool-dir`` streams step
and stage events into the live-observability spool under ``--run-id``, and
``--xla-profile`` (``repro``'s flag name) runs one post-warm-up step under
``torch.profiler``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.optim.adam import AdamW

def resolve_pipeline(plan, mode: str, devices=None):
    """Decide whether a lowered TAG plan's PIPE stages can really run on
    ``devices`` (default: every local device). Returns the ``StagePlan`` to
    execute, or None for the single-mesh data-parallel path, emitting an
    explicit log line either way, so that a strategy with PIPE actions is
    never silently degraded."""
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
        mesh_mod.stage_device_sets(sp, devices)
    except PipelineInfeasible as e:
        print(f"WARNING: TAG pipeline fallback — {e}; degrading to "
              f"single-mesh DP axis rules", flush=True)
        return None
    sched = sp.schedule if mode == "auto" else mode
    print(f"TAG pipeline: executing {sp.n_stages} stages "
          f"(schedule={sched}, placement={list(sp.placement)}, "
          f"sync={[s.sync for s in sp.stages]})", flush=True)
    return sp


def _stage_key(s: int) -> str:
    return f"stage{s}"


def _export_spans(args):
    """Write the session's planner/search spans as a Chrome trace
    (``--trace-dir``); no-op when tracing is off or nothing was recorded."""
    if not getattr(args, "trace_dir", ""):
        return
    from repro_torch.obs import chrome_trace, write_chrome_trace
    from repro_torch.obs.spans import get_tracer
    tracer = get_tracer()
    if not tracer.spans():
        return
    path = write_chrome_trace(
        os.path.join(args.trace_dir, "trace_spans.json"),
        chrome_trace(tracer.to_chrome(process_name="train"),
                     arch=args.arch, kind="spans"))
    print(f"trace: wrote {path} ({len(tracer.spans())} spans)", flush=True)


def _run_id(args) -> str:
    """One run id for the whole job: groups the spool shard under
    /traces/<run_id> and the telemetry records under /runs/<run_id> on the
    health analyzer's side."""
    return getattr(args, "run_id", "") or f"train-{args.arch}"


def _make_spool(args):
    """``--spool-dir``: a ``SpoolWriter`` shard for this training process,
    feeding the cross-process trace collector (``serve-metrics --spool-dir``
    on the other end). None when unset; tests drive these entry points with
    hand-built Namespaces."""
    spool_dir = getattr(args, "spool_dir", "")
    if not spool_dir:
        return None
    from repro_torch.obs.collector import SpoolWriter
    return SpoolWriter(spool_dir, run_id=_run_id(args), name="train",
                       meta={"arch": args.arch})


def _drain_tracer_to_spool(spool):
    """Ship this process's recorded planner/search spans (if any) into its
    spool shard beside the step and stage events."""
    if spool is None:
        return
    from repro_torch.obs.spans import get_tracer
    tracer = get_tracer()
    if tracer.spans():
        spool.emit_tracer(tracer)


@dataclasses.dataclass
class PipelineSession:
    """What ``build_pipeline`` sets up: the runner, the train step over
    per-stage lists, the stage states, the step to start from and the data."""
    runner: object
    step_fn: object
    params_list: list
    opt_state_list: list
    start_step: int
    dataset: SyntheticDataset
    schedule: str
    n_chunks: int
    n_micro: int


def build_pipeline(args, cfg, stage_plan, devices=None) -> PipelineSession:
    """Everything of ``run_pipeline`` up to its first step: the resolved
    schedule, ``n_micro`` and ``n_chunks``, the launch preflight, the stage
    parameters and optimizer states (or those of the per-stage checkpoint
    resumed), the runner and its train step."""
    from repro_torch.exec import CompiledPipelineRunner, PipelineRunner, split_model
    from repro_torch.exec.schedule import make_schedule
    from repro_torch.verify import PlanVerificationError, verify_preflight

    engine = getattr(args, "engine", None) or "eager"
    if engine not in ("eager", "scan"):
        raise ValueError(f"unknown pipeline engine {engine!r} (use eager or scan)")
    schedule = stage_plan.schedule if args.pipeline == "auto" else args.pipeline
    n_chunks = max(2, args.n_chunks) if schedule == "interleaved" else 1
    n_micro = max(1, args.n_micro)
    while n_micro > 1 and (args.batch % n_micro
                           or (schedule == "interleaved" and n_micro % stage_plan.n_stages)):
        n_micro -= 1
    if schedule == "interleaved" and n_micro % stage_plan.n_stages:
        raise ValueError(
            f"interleaved needs n_micro divisible by {stage_plan.n_stages} stages (and by "
            f"batch {args.batch}); none <= {args.n_micro} works — pick --n-micro/--batch "
            f"accordingly or another --pipeline schedule")
    if n_micro != args.n_micro:
        print(f"pipeline: n_micro {args.n_micro} -> {n_micro} (must divide batch {args.batch}"
              + (f" and be a multiple of {stage_plan.n_stages} stages"
                 if schedule == "interleaved" else "") + ")", flush=True)

    device_sets = mesh_mod.stage_device_sets(stage_plan, devices)

    # static preflight before any parameter is allocated: the resolved
    # (schedule, n_micro, n_chunks) and the actual device sets, verified
    # device-free; errors abort here, warnings print
    pre = verify_preflight(
        stage_plan, make_schedule(schedule, stage_plan.n_stages, n_micro, n_chunks=n_chunks),
        n_micro, n_chunks=n_chunks, device_counts=[len(d) for d in device_sets])
    if pre.errors():
        raise PlanVerificationError(
            pre, context=f"launch preflight ({schedule}, S={stage_plan.n_stages}, "
                         f"n_micro={n_micro})")
    for d in pre.warnings():
        print(f"preflight: {d.format()}", flush=True)

    dev0 = torch.device(device_sets[0][0])
    params = init_params(cfg, torch.Generator(device=dev0).manual_seed(args.seed), dev0)
    splits = stage_plan.layer_splits(cfg.num_periods, n_chunks=n_chunks)
    stage_params, fns, mb_keys, tied = split_model(
        cfg, params, stage_plan.n_stages * n_chunks, splits=splits)
    del params

    store = None
    if args.telemetry_dir:
        from repro_torch.runtime.telemetry import MeasurementStore
        store = MeasurementStore(args.telemetry_dir)
    kw = dict(schedule=schedule, n_micro=n_micro, n_chunks=n_chunks, mb_keys=mb_keys,
              tied_ref=tied, store=store, spool=_make_spool(args),
              meta={"arch": args.arch, "batch": args.batch, "seq": args.seq,
                    "launcher": "train", "engine": engine, "run_id": _run_id(args)})
    if engine == "scan":
        unroll = max(1, getattr(args, "scan_unroll", 1))
        runner = CompiledPipelineRunner(fns, stage_plan, device_sets, unroll=unroll, **kw)
        how = "CUDA graphs" if dev0.type == "cuda" else f"uncaptured on {dev0.type}"
        print(f"pipeline engine: scan ({how}, unroll={unroll})", flush=True)
    else:
        runner = PipelineRunner(fns, stage_plan, device_sets, **kw)
        print("pipeline engine: eager (one dispatch an event)", flush=True)

    opt = AdamW(lr=args.lr)
    params_list = runner.place_params(stage_params)
    n_virtual = len(params_list)
    opt_state_list = [runner.place(runner.phys(u), opt.init(p)) for u, p in enumerate(params_list)]
    start_step = 0
    if getattr(args, "resume", False) and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start_step, tree = load_checkpoint(args.ckpt_dir, device="cpu")
        keys = [_stage_key(u) for u in range(n_virtual)]
        if sorted(tree["params"]) != sorted(keys):
            raise ValueError(
                f"checkpoint in {args.ckpt_dir} is not a {n_virtual}-stage pipeline "
                f"checkpoint — resume it with the matching stage map and schedule "
                f"(or without --tag-search for single-mesh checkpoints)")
        params_list = [runner.place(runner.phys(u), tree["params"][k]) for u, k in enumerate(keys)]
        opt_state_list = [runner.place(runner.phys(u), tree["opt_state"][k])
                          for u, k in enumerate(keys)]
        print(f"resumed pipelined run from step {start_step}", flush=True)
    ds = SyntheticDataset(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                          frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
                          d_model=cfg.d_model)
    return PipelineSession(runner, steps_mod.make_pipeline_train_step(opt, runner), params_list,
                           opt_state_list, start_step, ds, schedule, n_chunks, n_micro)


def run_pipeline(args, cfg, stage_plan, devices=None):
    """Train through a pipeline engine (``exec.engine``; ``args.engine``,
    eager by default, and ``args.scan_unroll``) on
    ``devices`` (default: every local device; a list may repeat one, such as
    ``[cuda:0] * 2``). ``args`` carries the launcher's fields; tests pass a
    hand-built Namespace. ``args.trace_dir`` writes the last step's executed
    events as ``trace_executed.json``; ``args.spool_dir`` spools every step's
    events (``_make_spool``). Returns the losses."""
    run = build_pipeline(args, cfg, stage_plan, devices)
    schedule, n_chunks, n_micro = run.schedule, run.n_chunks, run.n_micro
    params_list, opt_state_list = run.params_list, run.opt_state_list
    start_step = run.start_step
    trace_dir = getattr(args, "trace_dir", None)
    record_steps = run.runner.store is not None or bool(trace_dir)
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = run.dataset.device_batch(step, "cpu")
        params_list, opt_state_list, metrics = run.step_fn(
            params_list, opt_state_list, step, batch, record=record_steps)
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            chunks = f"x{n_chunks}v" if n_chunks > 1 else ""
            print(f"step {step:5d} loss={metrics['loss']:.4f} ce={metrics['ce']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} "
                  f"[pipeline {schedule} x{stage_plan.n_stages}{chunks}]", flush=True)
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            # per-stage trees keyed by stage (the flat-npz checkpointer walks
            # dicts, not lists)
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": {_stage_key(s): p for s, p in enumerate(params_list)},
                             "opt_state": {_stage_key(s): o
                                           for s, o in enumerate(opt_state_list)}})
    dt = time.time() - t_start
    n = max(args.steps - start_step, 1)
    tail = f"; loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else ""
    print(f"done: {n} pipelined steps in {dt:.1f}s ({dt / n * 1e3:.0f} ms/step, "
          f"schedule={schedule}, stages={stage_plan.n_stages}, n_micro={n_micro}){tail}",
          flush=True)
    last = run.runner.last_stats
    if trace_dir and last is not None:
        from repro_torch.obs import chrome_trace, executed_trace_events, write_chrome_trace
        events = executed_trace_events(last, pid=0, process_name=f"executed [{schedule}]",
                                       n_stages=stage_plan.n_stages)
        path = write_chrome_trace(
            os.path.join(trace_dir, "trace_executed.json"),
            chrome_trace(events, arch=args.arch, schedule=schedule, n_micro=n_micro,
                         n_stages=stage_plan.n_stages))
        print(f"trace: wrote {path} ({len(last.events)} events)", flush=True)
    _drain_tracer_to_spool(run.runner.spool)
    return losses


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


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, as ``repro.launch.train`` parses them, plus
    ``--device``."""
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
                         "the searched strategy voted for, off forces single-mesh rules, "
                         "a schedule name asks for that schedule")
    ap.add_argument("--engine", choices=["eager", "scan"], default="eager",
                    help="pipeline execution engine: eager dispatches every schedule event "
                         "from Python; scan runs each stage's forward and backward loops "
                         "as CUDA graphs, captured at the first step (GPipe-like stash)")
    ap.add_argument("--scan-unroll", type=int, default=1,
                    help="microbatch bodies in one graph for --engine scan (1 keeps "
                         "capture time and graph memory flat in n_micro)")
    ap.add_argument("--n-micro", type=int, default=4, help="microbatches per pipelined step")
    ap.add_argument("--n-chunks", type=int, default=2,
                    help="virtual model chunks per stage for the interleaved schedule")
    ap.add_argument("--trace-dir", default="",
                    help="export Chrome traces here: the executed pipeline timeline of the "
                         "last step plus the planner/search span timeline")
    ap.add_argument("--spool-dir", default="",
                    help="append this process's step/stage events and spans to a shard in "
                         "this live-observability spool directory (merged across processes "
                         "by the trace collector, served by the service CLI's "
                         "serve-metrics)")
    ap.add_argument("--run-id", default="",
                    help="run id grouping this job's spool shard with other processes' "
                         "shards in /traces/<run_id> and its telemetry under "
                         "/runs/<run_id> (default: train-<arch>)")
    ap.add_argument("--xla-profile", action="store_true",
                    help="run one post-warm-up step under torch.profiler (CPU and CUDA "
                         "activities), write its Chrome trace and record its "
                         "per-collective samples into the telemetry log; the flag keeps "
                         "repro's name so that one command line runs on both")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.trace_dir:
        from repro_torch.obs.spans import Tracer, set_tracer
        set_tracer(Tracer(enabled=True))
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    mesh = mesh_mod.make_host_mesh(None if device.type == "cuda" else [device])
    rules = steps_mod.baseline_rules(mesh)

    if args.tag_search:
        t0 = time.perf_counter()
        result, plan = plan_deployment(args.arch, device, n_micro=args.n_micro)
        print(f"TAG search: {len(result.gg.base.nodes)} ops in {result.gg.n} groups, "
              f"simulated {result.time:.6g} s vs DP-AllReduce {result.baseline_time:.6g} s, "
              f"{len(result.sfb_plans)} SFB duplications, {time.perf_counter() - t0:.2f} s",
              flush=True)
        print(f"TAG plan: speedup={result.speedup:.2f}x "
              f"summary={json.dumps(plan.summary)}", flush=True)
        devices = list(mesh.devices.flat)
        stage_plan = resolve_pipeline(plan, args.pipeline, devices)
        if stage_plan is not None:
            losses = run_pipeline(args, cfg, stage_plan, devices)
            _export_spans(args)
            return losses
    opt = AdamW(lr=args.lr)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt_state = opt.init(params)
    start_step = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start_step, tree = load_checkpoint(args.ckpt_dir, device=device)
        if _stage_key(0) in tree.get("params", {}):
            raise ValueError(
                f"checkpoint in {args.ckpt_dir} is a per-stage pipeline checkpoint — "
                f"resume it through the pipeline path (--tag-search with the same "
                f"stage map)")
        params, opt_state = tree["params"], tree["opt_state"]
        print(f"resumed from step {start_step}", flush=True)

    ds = SyntheticDataset(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                          frontend_tokens=cfg.frontend_tokens if cfg.frontend != "none" else 0,
                          d_model=cfg.d_model)
    options = steps_mod.StepOptions(loss_chunk=args.loss_chunk)
    step_fn = steps_mod.make_train_step(cfg, opt, rules, options)
    raw_step_fn = step_fn
    timer = None
    if args.telemetry_dir:
        from repro_torch.runtime.telemetry import MeasurementStore, StepTimer
        timer = StepTimer(MeasurementStore(args.telemetry_dir),
                          meta={"arch": args.arch, "batch": args.batch, "seq": args.seq,
                                "launcher": "train", "run_id": _run_id(args),
                                "device": str(device)})
        step_fn = steps_mod.instrument_step(step_fn, timer)

    print(f"training {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on {device}, "
          f"data parallel over the host mesh {mesh.shape}", flush=True)
    # profile one post-warm-up step (the first pays the allocator's warm-up)
    profile_at = min(start_step + 1, args.steps - 1) if args.xla_profile else -1
    spool = _make_spool(args)
    losses = []
    t_start = time.time()
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = ds.device_batch(step, device)
        if step == profile_at:
            from repro_torch.obs.torch_profiler import profile_step
            log_dir = os.path.join(args.trace_dir or args.telemetry_dir or ".", "torch_profile")
            t0 = time.perf_counter()
            out, samples, pmeta = profile_step(raw_step_fn, params, opt_state, step, batch,
                                               log_dir=log_dir)
            wall = time.perf_counter() - t0
            params, opt_state, metrics = out
            print(f"xla-profile: {json.dumps(pmeta)} ({len(samples)} collective samples)",
                  flush=True)
            if timer is not None:
                timer.record(wall, collectives=samples)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, step, batch)
        loss = float(metrics["loss"])
        if spool is not None:
            spool.emit_span(f"step {step}", t_step, time.perf_counter(), tid=0, cat="train",
                            args={"step": step, "loss": loss})
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
    _drain_tracer_to_spool(spool)
    _export_spans(args)
    return losses


if __name__ == "__main__":
    main()
