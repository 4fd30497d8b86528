"""Planner-service CLI of the port: every command of ``repro.service.cli``
(``repro-plan``), with the same arguments, defaults and JSON keys.

    python -m repro_torch.service.cli plan --model vgg19 \
        --topo h100 --iterations 40 --cache-dir .plans
    python -m repro_torch.service.cli inspect --cache-dir .plans
    python -m repro_torch.service.cli evict --cache-dir .plans --max-age 86400
    python -m repro_torch.service.cli observe --model vgg19 --topo h100 \
        --observed-time 0.31 --cache-dir .plans --telemetry-dir .telemetry
    python -m repro_torch.service.cli calibrate --topo h100 \
        --telemetry-dir .telemetry --save profile.json
    python -m repro_torch.service.cli drift --model vgg19 --topo h100 \
        --observed-time 0.31 --cache-dir .plans
    python -m repro_torch.service.cli trace --model transformer --topo h100
    python -m repro_torch.service.cli verify --model resnet101 --topo h100
    python -m repro_torch.service.cli serve-metrics --port 0 --spool-dir .spool
    python -m repro_torch.service.cli metrics --url http://127.0.0.1:9464
    python -m repro_torch.service.cli health --telemetry-dir .telemetry \
        --slo-ms 350
    python -m repro_torch.service.cli policy train --models bert_small vgg19 \
        --name corpus-a --steps 16 --cache-dir .plans
    python -m repro_torch.service.cli policy list --cache-dir .plans
    python -m repro_torch.service.cli policy use --name corpus-a --cache-dir .plans

The zoo graphs (``core.zoo``) are traced on meta tensors by
``core.torch_export``. ``--topo`` also takes ``h100`` (``h100_nodes``).
``policy train`` and the commands that may build a GNN policy from the
registry (``plan``, ``observe``, ``verify``, ``serve-metrics``) take
``--device``: the policy runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.core import device as device_mod
from repro_torch.core.graph import group_graph
from repro_torch.core.torch_export import trace_training_graph
from repro_torch.core.partition import partition
from repro_torch.core.zoo import ZOO, build
from repro_torch.service.planner import POLICY_SUBDIR, PlannerService
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.store import PlanStore

TOPOLOGIES = {
    "testbed": device_mod.testbed,
    "cloud": device_mod.cloud,
    "2x1080ti": device_mod.two_1080ti,
    "2xv100": device_mod.homogeneous_2v100,
    "tpu": device_mod.tpu_pods,
    "h100": device_mod.h100_nodes,
}


def _build_topology(name: str):
    return TOPOLOGIES[name]()


def _build_grouped(args):
    loss_fn, params, batch = build(args.model, batch=args.batch)
    g = trace_training_graph(loss_fn, params, batch, args.model).simplify()
    return group_graph(g, partition(g, args.n_groups))


def cmd_plan(args) -> int:
    gg = _build_grouped(args)
    svc = PlannerService(cache_dir=args.cache_dir, device=args.device)
    resp = svc.plan_graph(gg, _build_topology(args.topo),
                          iterations=args.iterations, seed=args.seed,
                          enable_sfb=not args.no_sfb)
    print(json.dumps({
        "model": args.model, "topo": args.topo, "source": resp.source,
        "iterations_run": resp.iterations_run,
        "time_s": resp.time, "baseline_s": resp.baseline_time,
        "speedup": round(resp.speedup, 4),
        "policy": resp.policy, "verify": resp.verify,
        "graph_fp": resp.graph_fp[:16], "topo_fp": resp.topo_fp[:16],
        "stats": svc.stats(),
    }, indent=2))
    return 0


# -------------------------------------------------------- policy registry

def _registry(args) -> PolicyRegistry:
    return PolicyRegistry(os.path.join(args.cache_dir, POLICY_SUBDIR))


def cmd_policy_train(args) -> int:
    """Train a GNN policy on a corpus of zoo graphs and register it."""
    from repro_torch.core.trainer import init_trainer, train_policy
    from repro_torch.service.fingerprint import (
        fingerprint_grouped_cached, structural_features)

    graphs = []
    for model in args.models:
        loss_fn, params, batch = build(model)
        g = trace_training_graph(loss_fn, params, batch, model).simplify()
        graphs.append(group_graph(g, partition(g, args.n_groups)))
    topologies = [_build_topology(t) for t in args.topos] or None

    state = init_trainer(seed=args.seed, lr=args.lr, device=args.device)
    state = train_policy(state, graphs, steps=args.steps,
                         mcts_iters=args.mcts_iters, seed=args.seed,
                         topologies=topologies, verbose=args.verbose)

    reg = _registry(args)
    rec = reg.save(
        args.name, state.cfg, state.params,
        corpus=[fingerprint_grouped_cached(g) for g in graphs],
        corpus_features=[structural_features(g) for g in graphs],
        meta={"models": list(args.models), "topos": list(args.topos),
              "steps": args.steps, "mcts_iters": args.mcts_iters,
              "seed": args.seed, "n_groups": args.n_groups,
              "final_loss": state.losses[-1] if state.losses else None})
    print(json.dumps({
        "registered": rec.name, "models": args.models,
        "steps": args.steps, "mcts_iters": args.mcts_iters,
        "final_loss": rec.meta["final_loss"],
        "registry": reg.path, "policies": len(reg),
    }, indent=2))
    return 0


def cmd_policy_list(args) -> int:
    reg = _registry(args)
    default = reg.default_name()
    rows = [{
        "name": r.name, "default": r.name == default,
        "corpus": [fp[:16] for fp in r.corpus],
        "models": r.meta.get("models"), "steps": r.meta.get("steps"),
        "final_loss": r.meta.get("final_loss"), "created": r.created,
    } for r in reg.records()]
    print(json.dumps({"policies": rows, "count": len(rows),
                      "default": default}, indent=2))
    return 0


def cmd_policy_use(args) -> int:
    """Pin a registered policy: the planner serves every request with it
    (overrides corpus / structural matching) until re-pinned."""
    reg = _registry(args)
    try:
        reg.set_default(args.name)
    except (OSError, ValueError, KeyError) as e:
        print(json.dumps({"error": f"cannot pin {args.name!r}: {e}"}))
        return 1
    print(json.dumps({"default": args.name, "registry": reg.path}))
    return 0


def cmd_policy_evict(args) -> int:
    """Registry-level eviction: drop a named checkpoint and/or apply
    age / size / count budgets (pinned default is never evicted)."""
    reg = _registry(args)
    n = 0
    if args.name:
        n += int(reg.remove(args.name))
    if args.max_age is not None or args.max_bytes is not None \
            or args.max_count is not None:
        n += reg.evict_expired(max_age_s=args.max_age,
                               max_bytes=args.max_bytes,
                               max_count=args.max_count)
    print(json.dumps({"evicted": n, "remaining": len(reg),
                      "default": reg.default_name()}))
    return 0


def cmd_inspect(args) -> int:
    store = PlanStore(path=args.cache_dir)
    rows = [{
        "graph_fp": r.graph_fp[:16], "topo_fp": r.topo_fp[:16],
        "n_groups": r.n_groups, "topo_m": r.topo_m,
        "time_s": r.time, "speedup": round(r.speedup, 4),
        "meta": r.meta,
    } for r in store.records()]
    print(json.dumps({"records": rows, "count": len(rows)}, indent=2))
    return 0


def cmd_evict(args) -> int:
    store = PlanStore(path=args.cache_dir)
    n = 0
    if args.graph_fp or args.topo_fp or args.all:
        n += store.evict(graph_fp=args.graph_fp, topo_fp=args.topo_fp,
                         all=args.all)
    if args.max_age is not None or args.max_bytes is not None \
            or args.per_topo_quota is not None:
        n += store.evict_expired(max_age_s=args.max_age,
                                 max_bytes=args.max_bytes,
                                 per_topo_quota=args.per_topo_quota)
    print(json.dumps({"evicted": n, "remaining": len(store)}))
    return 0


def cmd_observe(args) -> int:
    """Feed an observed step time back: logs telemetry, and past the drift
    threshold invalidates + replans under a recalibrated cost model."""
    gg = _build_grouped(args)
    svc = PlannerService(cache_dir=args.cache_dir,
                         telemetry_dir=args.telemetry_dir,
                         drift_threshold=args.threshold, device=args.device)
    res = svc.observe(gg, _build_topology(args.topo), args.observed_time,
                      iterations=args.iterations, seed=args.seed)
    out = {"model": args.model, "topo": args.topo, "kind": res.kind,
           "observed_s": res.observed}
    if res.report is not None:
        out["drift"] = res.report.to_dict()
    if res.kind == "replanned":
        out["stale_time_s"] = res.stale_time
        out["new_time_s"] = res.response.time
        out["improved"] = res.improved
        if res.profile is not None:
            out["profile"] = res.profile.to_dict()
    print(json.dumps(out, indent=2))
    return 0


def cmd_calibrate(args) -> int:
    """Fit a CalibrationProfile from accumulated step telemetry."""
    from repro_torch.runtime.calibration import fit_profile
    from repro_torch.runtime.telemetry import MeasurementStore
    from repro_torch.service.fingerprint import fingerprint_topology
    topo = _build_topology(args.topo)
    store = MeasurementStore(args.telemetry_dir)
    recs = store.records(
        topo_fp=fingerprint_topology(topo) if args.match_topo else None)
    if not recs:
        print(json.dumps({"error": "no matching measurements",
                          "telemetry_dir": args.telemetry_dir}))
        return 1
    profile = fit_profile(recs, topo)
    if args.save:
        profile.save(args.save)
    print(json.dumps({"topo": args.topo, "records": len(recs),
                      "profile": profile.to_dict(),
                      "saved": args.save or None}, indent=2))
    return 0


def cmd_drift(args) -> int:
    """Report-only drift check of an observed time vs the cached plan."""
    from repro_torch.service.fingerprint import (
        fingerprint_grouped, fingerprint_topology)
    gg = _build_grouped(args)
    topo = _build_topology(args.topo)
    store = PlanStore(path=args.cache_dir)
    rec = store.get(fingerprint_grouped(gg), fingerprint_topology(topo))
    if rec is None:
        print(json.dumps({"error": "no cached plan for (model, topo)"}))
        return 1
    drift = abs(args.observed_time - rec.time) / rec.time \
        if rec.time > 0 else float("inf")
    print(json.dumps({
        "model": args.model, "topo": args.topo,
        "simulated_s": rec.time, "observed_s": args.observed_time,
        "drift": round(drift, 4), "threshold": args.threshold,
        "drifted": drift > args.threshold,
    }, indent=2))
    return 0


SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb")


def cmd_trace(args) -> int:
    """Export predicted + executed Chrome traces per schedule, plus the
    per-(stage, mb, kind) diff report attributing step-time error."""
    from repro_torch.core.strategy import Action, Option, Strategy
    from repro_torch.exec.replay import execute_pipeline
    from repro_torch.exec.schedule import make_schedule, simulate_schedule
    from repro_torch.exec.stages import build_stage_plan
    from repro_torch.obs import (
        chrome_trace, diff_report, executed_trace_events, format_diff,
        timeline_trace_events, write_chrome_trace)
    from repro_torch.obs.metrics import MetricsRegistry

    gg = _build_grouped(args)
    topo = _build_topology(args.topo)
    placement = tuple(range(topo.m))
    strat = Strategy([
        Action(placement, Option.PIPE) if i % 2 == 0
        else Action(placement, Option.PS) for i in range(gg.n)])
    plan = build_stage_plan(gg, strat, topo, n_micro=args.n_micro)
    if plan is None or plan.n_stages < 2:
        print(json.dumps(
            {"error": "no multi-stage pipeline spine for this "
                      "(model, topo)", "model": args.model,
             "topo": args.topo}))
        return 1
    S = plan.n_stages
    m = max(S, (args.n_micro // S) * S)   # interleaved needs m % S == 0
    plan.n_micro = m
    os.makedirs(args.out_dir, exist_ok=True)

    registry = MetricsRegistry()
    g_bubble = registry.gauge(
        "pipeline_bubble_fraction",
        "executed idle fraction of the pipeline flush per schedule")
    g_err = registry.gauge(
        "pipeline_step_error_frac",
        "(executed - predicted) / predicted step seconds per schedule")
    out = {"model": args.model, "topo": args.topo, "n_stages": S,
           "n_micro": m, "out_dir": args.out_dir, "schedules": {}}
    for name in (args.schedules or SCHEDULES):
        predicted = simulate_schedule(plan, topo,
                                      make_schedule(name, S, m))
        rec, tl = execute_pipeline(plan, topo, schedule=name,
                                   noise=args.noise, seed=args.seed)
        events = timeline_trace_events(
            predicted, pid=0, process_name=f"predicted [{name}]")
        events += executed_trace_events(
            rec, pid=1, process_name=f"executed [{name}]", n_stages=S)
        trace_path = write_chrome_trace(
            os.path.join(args.out_dir, f"trace_{args.model}_{name}.json"),
            chrome_trace(events, model=args.model, topo=args.topo,
                         schedule=name, n_micro=m))
        report = diff_report(predicted, rec,
                             executed_wall=rec.wall_time)
        diff_path = os.path.join(args.out_dir,
                                 f"diff_{args.model}_{name}.json")
        with open(diff_path, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        g_bubble.set(tl.bubble_fraction(), schedule=name)
        g_err.set(report["step_error_frac"], schedule=name)
        out["schedules"][name] = {
            "trace": trace_path, "diff": diff_path,
            "predicted_step_s": report["predicted_step_s"],
            "executed_step_s": report["executed_step_s"],
            "step_error_frac": report["step_error_frac"],
            "bubble_frac": tl.bubble_fraction(),
            "events_matched": report["events_matched"]}
        if args.verbose:
            print(f"--- {name} ---")
            print(format_diff(report))
    metrics_path = os.path.join(args.out_dir, "trace_metrics.prom")
    with open(metrics_path, "w") as f:
        f.write(registry.to_prometheus())
    out["metrics"] = metrics_path
    print(json.dumps(out, indent=2))
    return 0


def cmd_verify(args) -> int:
    """Static plan verification. ``--selftest`` runs the mutation
    harness (every injected violation class must be caught — the CI
    soundness gate); otherwise searches (or loads) a plan for
    (model, topo) and renders its diagnostics, exit 1 on errors."""
    from repro_torch.verify import run_selftest, verify_deployment

    if args.selftest:
        res = run_selftest()
        print(json.dumps(res, indent=2))
        return 0 if res["ok"] else 1
    if not args.model:
        print(json.dumps({"error": "verify needs --model (or "
                                   "--selftest)"}))
        return 2
    gg = _build_grouped(args)
    topo = _build_topology(args.topo)
    # verify="off": this command IS the verification — run it once,
    # below, with the full report instead of the cached summary
    svc = PlannerService(cache_dir=args.cache_dir, verify="off",
                         device=args.device)
    resp = svc.plan_graph(gg, topo, iterations=args.iterations,
                          seed=args.seed, enable_sfb=not args.no_sfb)
    rep = verify_deployment(gg, resp.strategy, topo,
                            n_micro=args.n_micro)
    if args.json:
        print(json.dumps({
            "model": args.model, "topo": args.topo,
            "source": resp.source, "verdict": rep.verdict,
            "summary": rep.summary(), "diagnostics": rep.to_dict(),
        }, indent=2))
    else:
        print(f"{args.model} on {args.topo} "
              f"(plan source: {resp.source}): {rep.verdict}")
        text = rep.format()
        if text:
            print(text)
    return 1 if rep.errors() else 0


def _metrics_once(args) -> None:
    """One metrics dump: from a running server (``--url``, validated
    through the exposition parser so the served text can't silently
    diverge from the format contract) or assembled locally."""
    if args.url:
        import urllib.request

        from repro_torch.obs.metrics import parse_prometheus_text
        base = args.url.rstrip("/")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode("utf-8")
        parse_prometheus_text(text)
        if args.format == "prometheus":
            print(text, end="" if text.endswith("\n") else "\n")
        else:
            with urllib.request.urlopen(base + "/plans", timeout=30) as r:
                print(r.read().decode("utf-8"), end="")
        return
    from repro_torch.obs.spans import export_tracer_metrics
    svc = PlannerService(cache_dir=args.cache_dir)
    registry = svc.metrics
    registry.gauge("planner_store_size",
                   "plans resident in the store").set(len(svc.store))
    export_tracer_metrics(registry)
    fitted = 0
    if args.telemetry_dir:
        from repro_torch.runtime.calibration import fit_profile, profile_metrics
        from repro_torch.runtime.telemetry import MeasurementStore
        recs = MeasurementStore(args.telemetry_dir).records()
        if recs:
            profile = fit_profile(recs, _build_topology(args.topo))
            profile_metrics(profile, registry)
            fitted = len(recs)
    if args.format == "prometheus":
        print(registry.to_prometheus())
    else:
        print(json.dumps({"stats": svc.stats(),
                          "telemetry_records": fitted}, indent=2))


def cmd_metrics(args) -> int:
    """Operational metrics snapshot: planner store gauges plus — given a
    telemetry dir — the calibration fit (per-device-type AND per-op-type
    utilization, link efficiencies) as gauges. ``--watch S`` re-dumps
    every S seconds; ``--url`` reads a running ``serve-metrics`` server
    instead of assembling metrics locally."""
    import time as time_mod
    n = 0
    while True:
        _metrics_once(args)
        n += 1
        if not args.watch or (args.watch_count and n >= args.watch_count):
            return 0
        time_mod.sleep(args.watch)


def cmd_serve_metrics(args) -> int:
    """Run the live observability plane: /metrics, /healthz,
    /traces/<run_id>, /plans, /runs, /alerts — plus (unless
    ``--no-recalibrate``) the background recalibration loop polling the
    telemetry dir and replanning watched workloads on drift, ordered by
    the health analyzer's attribution."""
    import time as time_mod

    from repro_torch.obs.alerts import load_rules
    from repro_torch.obs.collector import SpoolWriter, TraceCollector
    from repro_torch.obs.health import RunHealthAnalyzer
    from repro_torch.obs.server import ObsServer
    from repro_torch.runtime.telemetry import MeasurementStore

    svc = PlannerService(cache_dir=args.cache_dir,
                         telemetry_dir=args.telemetry_dir or None,
                         drift_threshold=args.threshold, device=args.device)
    spool = collector = loop = analyzer = None
    if args.spool_dir:
        spool = SpoolWriter(args.spool_dir, run_id=args.run_id,
                            name="planner")
        collector = TraceCollector(args.spool_dir)
        # serving a spool implies the planner's own spans are wanted in
        # the merged trace
        from repro_torch.obs.spans import get_tracer
        get_tracer().enable()
    if not args.no_health:
        rules = load_rules(args.alert_rules) if args.alert_rules else None
        hstore = MeasurementStore(args.telemetry_dir) \
            if args.telemetry_dir else None
        analyzer = RunHealthAnalyzer(
            hstore, registry=svc.metrics,
            slo_s=args.slo_ms / 1000.0 if args.slo_ms else None,
            slo_objective=args.slo_objective, alert_rules=rules)
    watched = None
    if not args.no_recalibrate:
        from repro_torch.runtime.feedback import RecalibrationLoop
        loop = RecalibrationLoop(svc, interval_s=args.interval,
                                 iterations=args.iterations,
                                 health=analyzer)
        if args.model:
            watched = loop.watch(_build_grouped(args),
                                 _build_topology(args.topo))
    server = ObsServer(registry=svc.metrics, service=svc,
                       collector=collector, spool=spool, recalib=loop,
                       health=analyzer, host=args.host, port=args.port,
                       spool_max_age_s=args.spool_max_age,
                       spool_max_bytes=args.spool_max_bytes)
    server.start()
    print(json.dumps({
        "url": server.url,
        "endpoints": ["/metrics", "/healthz", "/plans",
                      "/plans/<fingerprint>/verify", "/traces",
                      "/traces/<run_id>", "/runs",
                      "/runs/<run_id>/health", "/alerts"],
        "cache_dir": args.cache_dir,
        "telemetry_dir": args.telemetry_dir or None,
        "spool_dir": args.spool_dir or None,
        "recalibrate": loop is not None,
        "health": analyzer is not None,
        "slo_ms": args.slo_ms or None,
        "watched": list(watched) if watched else None,
    }, indent=2), flush=True)
    try:
        if args.duration > 0:
            time_mod.sleep(args.duration)
        else:
            while True:
                time_mod.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_health(args) -> int:
    """Run-health snapshot: per-run residual attribution, straggler
    ranking, SLO burn rates and alert states. ``--url`` reads a running
    ``serve-metrics`` server (/runs, /runs/<id>/health, /alerts);
    otherwise a local ``RunHealthAnalyzer`` drains the telemetry dir
    once and renders the same view."""
    if args.url:
        import urllib.request
        base = args.url.rstrip("/")

        def _get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return json.loads(r.read().decode("utf-8"))

        runs = _get("/runs")
        out = {"url": base, "runs": runs, "alerts": _get("/alerts")}
        if args.run_id:
            out["health"] = _get(f"/runs/{args.run_id}/health")
        else:
            out["health"] = {
                r["run_id"]: _get(f"/runs/{r['run_id']}/health")
                for r in runs.get("runs", [])}
        print(json.dumps(out, indent=2))
        return 0

    from repro_torch.obs.alerts import load_rules
    from repro_torch.obs.health import RunHealthAnalyzer
    from repro_torch.runtime.telemetry import MeasurementStore
    rules = load_rules(args.alert_rules) if args.alert_rules else None
    analyzer = RunHealthAnalyzer(
        MeasurementStore(args.telemetry_dir),
        slo_s=args.slo_ms / 1000.0 if args.slo_ms else None,
        slo_objective=args.slo_objective, alert_rules=rules)
    n = analyzer.poll()
    if n == 0:
        print(json.dumps({"error": "no telemetry records",
                          "telemetry_dir": args.telemetry_dir}))
        return 1
    out = {"telemetry_dir": args.telemetry_dir, "ingested": n,
           "runs": analyzer.run_summaries(),
           "alerts": analyzer.alerts(),
           "stats": analyzer.stats()}
    ids = [args.run_id] if args.run_id else analyzer.run_ids()
    try:
        out["health"] = {rid: analyzer.health(rid) for rid in ids}
    except KeyError:
        print(json.dumps({"error": f"unknown run {args.run_id!r}",
                          "runs": analyzer.run_ids()}))
        return 1
    print(json.dumps(out, indent=2))
    return 0


def _add_device_arg(p):
    p.add_argument("--device", default=None,
                   help="device of a GNN policy built from the registry: cuda "
                        "(default; raises without a card) or cpu")


def _add_model_args(p):
    p.add_argument("--model", choices=sorted(ZOO), required=True)
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--n-groups", type=int, default=30)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=".plans")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.service.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plan", help="plan a zoo model on a topology")
    _add_model_args(p)
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--no-sfb", action="store_true")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("inspect", help="list cached plan records")
    p.add_argument("--cache-dir", default=".plans")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("evict", help="remove cached plan records")
    p.add_argument("--cache-dir", default=".plans")
    p.add_argument("--graph-fp", default=None,
                   help="graph fingerprint (prefix) to evict")
    p.add_argument("--topo-fp", default=None,
                   help="topology fingerprint (prefix) to evict")
    p.add_argument("--all", action="store_true")
    p.add_argument("--max-age", type=float, default=None,
                   help="evict disk records older than SECONDS")
    p.add_argument("--max-bytes", type=int, default=None,
                   help="shrink the disk tier to this many bytes")
    p.add_argument("--per-topo-quota", type=int, default=None,
                   help="keep at most N records per topology")
    p.set_defaults(fn=cmd_evict)

    p = sub.add_parser("observe",
                       help="feed an observed step time into the "
                            "runtime feedback loop")
    _add_model_args(p)
    p.add_argument("--observed-time", type=float, required=True,
                   help="measured per-step wall time (s)")
    p.add_argument("--telemetry-dir", default=".telemetry")
    p.add_argument("--threshold", type=float, default=0.25)
    p.add_argument("--iterations", type=int, default=20,
                   help="re-search budget on drift")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_observe)

    p = sub.add_parser("calibrate",
                       help="fit a calibration profile from telemetry")
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--telemetry-dir", default=".telemetry")
    p.add_argument("--match-topo", action="store_true",
                   help="only use records whose topo fingerprint matches")
    p.add_argument("--save", default=None,
                   help="write the fitted profile JSON here")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("drift",
                       help="report observed-vs-simulated drift "
                            "(no invalidation)")
    _add_model_args(p)
    p.add_argument("--observed-time", type=float, required=True)
    p.add_argument("--threshold", type=float, default=0.25)
    p.set_defaults(fn=cmd_drift)

    p = sub.add_parser("trace",
                       help="export predicted + executed Chrome traces "
                            "and the predicted-vs-executed diff report")
    _add_model_args(p)
    p.add_argument("--schedules", nargs="*", choices=SCHEDULES,
                   default=None,
                   help="schedules to trace (default: all four)")
    p.add_argument("--n-micro", type=int, default=8,
                   help="microbatches per step (rounded to a multiple "
                        "of the stage count)")
    p.add_argument("--noise", type=float, default=0.0,
                   help="relative jitter on executed samples (makes the "
                        "diff report non-trivial)")
    p.add_argument("--out-dir", default="traces")
    p.add_argument("--verbose", action="store_true",
                   help="print the human diff per schedule")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("verify",
                       help="static plan verification: lint a searched "
                            "deployment (or --selftest the verifier's "
                            "mutation harness)")
    p.add_argument("--selftest", action="store_true",
                   help="run the mutation self-test across all four "
                        "schedule families; exit 1 on any miss")
    p.add_argument("--model", choices=sorted(ZOO), default=None)
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--n-groups", type=int, default=30)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=".plans")
    p.add_argument("--iterations", type=int, default=40,
                   help="search budget when the plan is not cached")
    p.add_argument("--n-micro", type=int, default=None,
                   help="verify at this microbatch count (default: the "
                        "plan's own)")
    p.add_argument("--no-sfb", action="store_true")
    p.add_argument("--json", action="store_true",
                   help="machine-readable diagnostics")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("metrics",
                       help="dump planner + calibration metrics "
                            "(Prometheus text or JSON)")
    p.add_argument("--cache-dir", default=".plans")
    p.add_argument("--telemetry-dir", default=None,
                   help="fit a calibration profile from this telemetry "
                        "and surface it as gauges")
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--format", choices=("prometheus", "json"),
                   default="prometheus")
    p.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                   help="re-dump every SECONDS (0: once)")
    p.add_argument("--watch-count", type=int, default=0,
                   help="with --watch: stop after N dumps (0: forever)")
    p.add_argument("--url", default="",
                   help="read /metrics from a running serve-metrics "
                        "server (validated through the exposition "
                        "parser) instead of assembling locally")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("serve-metrics",
                       help="serve /metrics, /healthz, /traces/<run_id>, "
                            "/plans; optionally run the continuous "
                            "recalibration loop")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9464,
                   help="bind port (0: pick a free one; printed as JSON "
                        "on startup)")
    p.add_argument("--cache-dir", default=".plans")
    p.add_argument("--telemetry-dir", default=".telemetry",
                   help="measurement log the recalibration loop polls "
                        "via read_new()")
    p.add_argument("--spool-dir", default="",
                   help="cross-process trace spool to collect and serve "
                        "under /traces/<run_id>")
    p.add_argument("--run-id", default="planner",
                   help="run id for this process's own spool shard")
    p.add_argument("--spool-max-age", type=float, default=None,
                   metavar="SECONDS",
                   help="retention GC: delete fully-drained spool "
                        "shards older than SECONDS on each scrape")
    p.add_argument("--spool-max-bytes", type=int, default=None,
                   help="retention GC: shrink drained spool shards to "
                        "this many bytes (oldest deleted first)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="recalibration poll interval (s)")
    p.add_argument("--iterations", type=int, default=20,
                   help="re-search budget when drift trips")
    p.add_argument("--threshold", type=float, default=0.25,
                   help="EWMA drift threshold")
    p.add_argument("--no-recalibrate", action="store_true",
                   help="serve only; no background feedback loop")
    p.add_argument("--model", choices=sorted(ZOO), default=None,
                   help="watch this zoo model for unattended replanning "
                        "(with --topo/--n-groups/--batch)")
    p.add_argument("--topo", choices=sorted(TOPOLOGIES), default="testbed")
    p.add_argument("--n-groups", type=int, default=30)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--duration", type=float, default=0.0,
                   help="serve for SECONDS then exit (0: until "
                        "interrupted) — CI smoke uses this")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="step-time SLO target in milliseconds; arms "
                        "burn-rate alerting on /alerts")
    p.add_argument("--slo-objective", type=float, default=0.99,
                   help="fraction of steps that must meet the target "
                        "(error budget = 1 - objective)")
    p.add_argument("--alert-rules", default=None, metavar="PATH",
                   help="JSON AlertRule list overriding the default "
                        "page/warn burn-rate pair")
    p.add_argument("--no-health", action="store_true",
                   help="disable the run-health analyzer (/runs, "
                        "/alerts return 404)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve_metrics)

    p = sub.add_parser("health",
                       help="run-health snapshot: residual attribution, "
                            "stragglers, SLO burn rates, alert states")
    p.add_argument("--telemetry-dir", default=".telemetry",
                   help="measurement log to drain (local mode)")
    p.add_argument("--run-id", default=None,
                   help="restrict the detail view to one run")
    p.add_argument("--slo-ms", type=float, default=None)
    p.add_argument("--slo-objective", type=float, default=0.99)
    p.add_argument("--alert-rules", default=None, metavar="PATH")
    p.add_argument("--url", default="",
                   help="read /runs + /runs/<id>/health + /alerts from "
                        "a running serve-metrics server instead of "
                        "draining telemetry locally")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser("policy",
                       help="train / list / pin registered GNN policies")
    psub = p.add_subparsers(dest="policy_cmd", required=True)

    pp = psub.add_parser("train",
                         help="train a policy on zoo graphs + register it")
    pp.add_argument("--models", nargs="+", choices=sorted(ZOO),
                    required=True)
    pp.add_argument("--name", required=True,
                    help="registry name for the checkpoint")
    pp.add_argument("--topos", nargs="*", choices=sorted(TOPOLOGIES),
                    default=[],
                    help="training topologies (default: random per step)")
    pp.add_argument("--steps", type=int, default=16)
    pp.add_argument("--mcts-iters", type=int, default=16)
    pp.add_argument("--n-groups", type=int, default=30)
    pp.add_argument("--lr", type=float, default=3e-4)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--cache-dir", default=".plans")
    pp.add_argument("--verbose", action="store_true")
    pp.add_argument("--device", default=None,
                    help="device the policy trains on: cuda (default; raises "
                         "without a card) or cpu")
    pp.set_defaults(fn=cmd_policy_train)

    pp = psub.add_parser("list", help="list registered policies")
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_list)

    pp = psub.add_parser("use", help="pin the policy served by default")
    pp.add_argument("--name", required=True)
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_use)

    pp = psub.add_parser("evict",
                         help="drop checkpoints by name or budget "
                              "(age/bytes/count; pinned default kept)")
    pp.add_argument("--name", default=None,
                    help="remove this checkpoint")
    pp.add_argument("--max-age", type=float, default=None,
                    help="evict checkpoints older than SECONDS")
    pp.add_argument("--max-bytes", type=int, default=None,
                    help="shrink the registry to this many bytes")
    pp.add_argument("--max-count", type=int, default=None,
                    help="keep at most N checkpoints (newest win)")
    pp.add_argument("--cache-dir", default=".plans")
    pp.set_defaults(fn=cmd_policy_evict)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
