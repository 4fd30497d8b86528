"""The port's observability layer (``repro_torch.obs``, ``exec/replay.py``)
against ``repro``'s.

``repro``'s ``tests/test_obs.py`` and ``tests/test_health.py`` run on both
packages: each file's source is loaded once with its imports as they are and
once with every ``repro.`` import pointed at ``repro_torch`` (and
``xla_profiler`` at its counterpart ``torch_profiler``), and every test of
each copy is collected here as ``test_<pkg>__<name>``. The one test that
patches ``jax.profiler`` has a port counterpart below, with the port's other
profiler cases: a real ``torch.profiler`` trace on the CPU, and a profiler
that fails raises instead of running the step again.

Then both packages side by side on the same inputs: the same replayed
``StepRecord``s (1e-9), the same Chrome documents and diff reports for all
four schedules, byte-equal spool shards and equal merged traces, and equal
health summaries. Last the port's engines with ``spool=`` on ``[cpu] * 4``
and its launcher's profiled step.
"""
import copy
import gzip
import importlib
import json
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

HERE = os.path.dirname(os.path.abspath(__file__))
PKG_ROOTS = {"repro": "repro", "port": "repro_torch"}
TOL = 1e-9
SCHEDULES = ("gpipe", "1f1b", "interleaved", "zb")


def load_variant(test_file: str, pkg: str, namespace: dict, skip=()) -> types.ModuleType:
    """Load ``tests/<test_file>`` for ``pkg``: as it is for ``repro``, with
    every ``repro.`` import (the subprocesses' code included) pointed at
    ``repro_torch`` for the port. Its tests go into ``namespace`` as
    ``test_<pkg>__<name>``, all but those named in ``skip``."""
    path = os.path.join(HERE, test_file)
    with open(path) as f:
        src = f.read()
    if pkg == "port":
        src = re.sub(r"\brepro\.", "repro_torch.", src)
        src = src.replace("xla_profiler as xp", "torch_profiler as xp")
    mod = types.ModuleType(f"{test_file[:-3]}__{pkg}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    for name, fn in vars(mod).items():
        if name.startswith("test_") and callable(fn) and name not in skip:
            namespace[f"test_{pkg}__{name[5:]}"] = fn
    return mod


# patches jax.profiler.trace; the port's counterpart is
# test_port_profile_step_no_trace below
JAX_ONLY = ("test_profile_step_no_trace",)
for _pkg in PKG_ROOTS:
    load_variant("test_obs.py", _pkg, globals(), skip=JAX_ONLY if _pkg == "port" else ())
    load_variant("test_health.py", _pkg, globals())


def _ns(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        graph=m("core.graph"), device=m("core.device"), S=m("core.strategy"),
        stages=m("exec.stages"), schedule=m("exec.schedule"), replay=m("exec.replay"),
        obs=m("obs"), collector=m("obs.collector"),
        health=m("obs.health"), telemetry=m("runtime.telemetry"))


NS = {pkg: _ns(root) for pkg, root in PKG_ROOTS.items()}
R, T = NS["repro"], NS["port"]


def _chain_gg(ns, n_ops=12, n_groups=6, edge_bytes=4e6):
    g = ns.graph.CompGraph(name=f"chain{n_ops}")
    for i in range(n_ops):
        g.add_node(ns.graph.OpNode(i, f"op{i}", "dot_general", flops=1e9 * (1 + i % 3),
                                   bytes_out=edge_bytes, param_bytes=4e5, grad_bytes=4e5,
                                   is_grad_producer=True))
        if i:
            g.add_edge(i - 1, i, edge_bytes)
    return ns.graph.group_graph(g, {i: i * n_groups // n_ops for i in range(n_ops)})


def _plan(ns, schedule: str):
    gg, topo = _chain_gg(ns), ns.device.testbed()
    strat = ns.S.Strategy([ns.S.Action((0, 1, 5), ns.S.Option.PIPE) if i % 2 == 0
                           else ns.S.Action((0, 1, 5), ns.S.Option.PS) for i in range(gg.n)])
    plan = ns.stages.build_stage_plan(gg, strat, topo, n_micro=8)
    if schedule == "interleaved":
        plan.n_micro = 2 * plan.n_stages
    return plan, topo


def _close(a, b, path="") -> None:
    """``a`` and ``b`` (nested JSON-like values) equal, floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=TOL, abs=TOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def keys_of(obj):
    """The key structure of a JSON value: dict keys (recursively), the
    items of a list merged."""
    if isinstance(obj, dict):
        return {k: keys_of(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        merged = {}
        for v in obj:
            k = keys_of(v)
            if isinstance(k, dict):
                merged.update(k)
        return [merged] if merged else []
    return None


def _replay(ns, schedule, **kw):
    plan, topo = _plan(ns, schedule)
    rec, tl = ns.replay.execute_pipeline(plan, topo, schedule=schedule, **kw)
    return plan, topo, rec, tl


# ----------------------------------------------------------------- replay

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_replay_records_match_repro(schedule):
    """``execute_pipeline`` on the same plan, schedule, noise and seed: the
    same record, sample for sample, and the same executed timeline."""
    got = [_replay(ns, schedule, noise=0.1, seed=3, step=2, meta={"run_id": "r"})
           for ns in (R, T)]
    (_, _, rr, rtl), (_, _, tr, ttl) = got
    _close(rr.to_dict(), tr.to_dict())
    _close([(e.kind, e.stage, e.mb, e.chunk, e.src, e.start, e.finish) for e in rtl.events],
           [(e.kind, e.stage, e.mb, e.chunk, e.src, e.start, e.finish) for e in ttl.events])


# -------------------------------------------------- Chrome traces and diffs

@pytest.mark.parametrize("schedule", SCHEDULES)
def test_chrome_documents_and_diff_reports_match_repro(schedule, tmp_path):
    """Predicted and executed trace events, the written document (``.gz``
    included) and the diff report are ``repro``'s on the same plan."""
    out = {}
    for pkg, ns in NS.items():
        plan, topo, rec, _ = _replay(ns, schedule, noise=0.05, seed=1)
        pred = ns.schedule.simulate_schedule(
            plan, topo, ns.schedule.make_schedule(schedule, plan.n_stages, plan.n_micro))
        events = ns.obs.timeline_trace_events(pred, pid=0, process_name=f"predicted [{schedule}]")
        events += ns.obs.executed_trace_events(rec, pid=1, process_name="executed",
                                               n_stages=plan.n_stages)
        path = ns.obs.write_chrome_trace(str(tmp_path / pkg / "t.json.gz"),
                                         ns.obs.chrome_trace(events, schedule=schedule))
        doc = ns.obs.validate_chrome_trace(json.load(gzip.open(path, "rt")))
        report = ns.obs.diff_report(pred, rec, executed_wall=rec.wall_time)
        out[pkg] = (doc, report, ns.obs.format_diff(report),
                    ns.obs.aggregate_events(ns.obs.executed_events_of(rec)))
    _close(out["repro"][:2], out["port"][:2])
    assert out["repro"][2].splitlines()[1:] == out["port"][2].splitlines()[1:]
    _close(list(out["repro"][3].values()), list(out["port"][3].values()))


def test_executed_events_of_reads_the_port_step_stats():
    """The port's ``StepStats`` 6-tuples and a ``StepRecord``'s
    ``meta["events"]`` normalize as ``repro``'s do."""
    from repro_torch.exec.engine import StepStats
    evs = [("F", 0, 0, 0.5, 0, 0.0), ("B", 1, -1, 0.25, 1, 0.75)]
    got = T.obs.executed_events_of(StepStats(loss=0.0, metrics={}, wall_time=1.0, events=evs))
    assert got == R.obs.executed_events_of(types.SimpleNamespace(events=evs))
    assert got[1] == {"kind": "B", "stage": 1, "mb": -1, "chunk": 1, "src": -1, "start": 0.75,
                      "finish": 1.0}
    rec = T.telemetry.StepRecord(meta={"events": got})
    assert T.obs.executed_events_of(rec) == got


# ------------------------------------------------------- spool and collector

def test_spool_shards_byte_equal_and_merged_traces_match(tmp_path):
    """Spool writers with the same anchor and pid write byte-equal shards
    (tracks, spans, a drained tracer, a replay's events); the collectors
    merge them into the same Chrome document."""
    docs, shards = {}, {}
    for pkg, ns in NS.items():
        d = str(tmp_path / pkg)
        w = ns.collector.SpoolWriter(d, run_id="r1", name="train", pid=7, anchor=(1000.0, 5.0),
                                     meta={"arch": "x"})
        w.emit_track(0, "stage 0")
        w.emit_span("step 0", 5.5, 6.0, tid=0, cat="train", args={"loss": 1.25})
        tr = ns.obs.Tracer(enabled=True)
        tr._epoch = 6.0
        with tr.span("plan", cat="planner"):
            pass
        tr._spans[0].start, tr._spans[0].end = 0.125, 0.5
        w.emit_tracer(tr)
        plan, topo = _plan(ns, "1f1b")
        replay_spool = ns.collector.SpoolWriter(d, run_id="r1", name="replay", pid=8,
                                                anchor=(1000.5, 0.0))
        ns.replay.execute_pipeline(plan, topo, schedule="1f1b", spool=replay_spool)
        with open(w.path) as f:
            shards[pkg] = f.read()
        c = ns.collector.TraceCollector(d)
        c.poll()
        docs[pkg] = c.chrome("r1")
    assert shards["repro"] == shards["port"]
    # the replay shard re-bases simulated seconds onto the process clock at
    # emission; only its spans' positions depend on when it ran
    strip = lambda doc: [(e["name"], e["ph"], e.get("tid"), e.get("args", {}).get("process"))  # noqa: E731
                         for e in doc["traceEvents"]]
    assert strip(docs["repro"]) == strip(docs["port"])


# ------------------------------------------------------------------ health

def parse_prometheus(ns, reg) -> dict:
    """The registry's exposition, parsed, without the analyzer's own
    timing series (host time, different on every run)."""
    fams = ns.obs.parse_prometheus_text(reg.to_prometheus())
    return {k: v for k, v in fams.items() if "seconds" not in k}


def test_health_summaries_match_repro():
    """One analyzer a package, the same watched timeline and the same
    replayed records of a slowed link: the same health, run summaries,
    alerts, replan priority and exported metrics."""
    out = {}
    for pkg, ns in NS.items():
        plan, topo = _plan(ns, "1f1b")
        tl = ns.schedule.simulate_schedule(plan, topo, ns.schedule.make_schedule(
            "1f1b", plan.n_stages, plan.n_micro))
        true = copy.deepcopy(topo)
        g1, g2 = plan.stages[1].device_group, plan.stages[2].device_group
        true.inter_bw[g1, g2] /= 3.0
        an = ns.health.RunHealthAnalyzer(slo_s=tl.makespan * 1.05)
        an.watch("runA", timeline=tl, graph_fp="G" * 40, topo_fp="T" * 40)
        for step in range(6):
            rec, _ = ns.replay.execute_pipeline(plan, true, schedule="1f1b", step=step,
                                                meta={"run_id": "runA"})
            rec.ts = 1000.0 + 10.0 * step
            an.ingest(rec)
        health = an.health("runA")
        health.pop("updated", None)
        reg = ns.obs.MetricsRegistry()
        an.export_metrics(reg)
        out[pkg] = (health, an.run_summaries(), an.alerts(),
                    {str(k): v for k, v in an.replan_priority().items()},
                    parse_prometheus(ns, reg))
    _close(out["repro"], out["port"])
    assert out["repro"][0]["dominant"]["key"] == "1->2"


# ---------------------------------------------------------- torch.profiler

def test_port_profile_step_no_trace(monkeypatch, tmp_path):
    """No trace file to parse: ``"no_trace"``, and the step ran once."""
    from repro_torch.obs import torch_profiler as tp
    calls = []
    monkeypatch.setattr(tp, "find_trace_files", lambda d: [])
    out, samples, meta = tp.profile_step(lambda: calls.append(1) or 7, log_dir=str(tmp_path))
    assert out == 7 and samples == [] and calls == [1]
    assert meta["profiler"] == "no_trace"


def test_port_profile_step_traces_the_step_once(tmp_path):
    """A real ``torch.profiler`` trace on the CPU: the Chrome file that
    ``export_chrome_trace`` wrote is found and parsed, holds the step's ops
    and no collective; the step ran once."""
    from repro_torch.obs import torch_profiler as tp
    calls = []

    def step(a, b):
        calls.append(1)
        return a @ b

    a = torch.ones(64, 64)
    out, samples, meta = tp.profile_step(step, a, a, log_dir=str(tmp_path / "prof"))
    assert calls == [1] and torch.equal(out, a @ a)
    assert meta["profiler"] == "ok" and meta["n_collectives"] == 0 and samples == []
    assert tp.find_trace_files(str(tmp_path / "prof")) == [meta["trace_file"]]
    with open(meta["trace_file"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_port_profile_step_raises_when_the_profiler_fails(monkeypatch, tmp_path):
    """``repro`` runs the step a second time, unprofiled, when its trace
    context fails; the port raises, and the step does not run again."""
    from repro_torch.obs import torch_profiler as tp

    class Broken:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            raise RuntimeError("profiler backend refused")

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    calls = []
    with pytest.raises(RuntimeError, match="refused"):
        tp.profile_step(lambda: calls.append(1), log_dir=str(tmp_path))
    assert calls == []


def test_obs_exports_repro_names():
    """``repro_torch.obs`` exports ``repro.obs``'s names, ``torch_profiler``'s
    in place of ``xla_profiler``'s."""
    assert sorted(T.obs.__all__) == sorted(R.obs.__all__)
    for name in ("profile_step", "classify_op", "attach_collectives"):
        assert getattr(T.obs, name).__module__ == "repro_torch.obs.torch_profiler"


# ----------------------------------------------------- the engines' spool

def _pipeline_runner(engine: str, spool):
    from repro_torch.configs import get_reduced
    from repro_torch.exec import CompiledPipelineRunner, PipelineRunner, split_model
    from repro_torch.exec.stages import StagePlan, StageSpec
    from repro_torch.models.model import init_params
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    plan = StagePlan(
        stages=[StageSpec(i, i, [i], flops=1e9, param_bytes=0, grad_bytes=0, out_bytes=1e5,
                          n_devices=2, gpu_type="V100") for i in range(2)],
        placement=(0, 1), n_micro=4, schedule="zb")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stage_params, fns, mb_keys, tied = split_model(cfg, params, 2, splits=plan.layer_splits(
        cfg.num_periods))
    cls = CompiledPipelineRunner if engine == "scan" else PipelineRunner
    runner = cls(fns, plan, [[torch.device("cpu")] * 2] * 2, schedule="zb", mb_keys=mb_keys,
                 tied_ref=tied, spool=spool)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int64))
             for k in ("tokens", "labels")}
    return runner, runner.place_params(stage_params), batch


@pytest.mark.parametrize("engine", ["eager", "scan"])
def test_engine_spool_streams_every_step(engine, tmp_path):
    """``spool=`` on both engines over ``[cpu] * 4`` (2 stages of 2 shards,
    zero-bubble): it turns event recording on, and each step's events go
    to the shard once, after one track a stage; the collector merges them
    under the events' names (a loop of the compiled engine has ``mb == -1``)."""
    spool = T.collector.SpoolWriter(str(tmp_path), run_id="pipe", name="train")
    runner, params, batch = _pipeline_runner(engine, spool)
    for _ in range(2):
        _, stats = runner.step(params, batch)
    assert stats.events and all(len(e) == 6 for e in stats.events)
    n_ev = len(stats.events)
    assert n_ev == (len(runner.flat) if engine == "eager" else 3 * runner.U)
    with open(spool.path) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["type"] == "anchor"
    assert [r for r in recs if r["type"] == "track"] == [
        {"type": "track", "tid": s, "name": f"stage {s}"} for s in range(2)]
    spans = [r for r in recs if r["type"] == "span"]
    assert len(spans) == 2 * n_ev
    want = [T.obs.event_name(k, s, m, c) for k, s, m, _, c, _ in stats.events]
    assert [r["name"] for r in spans[n_ev:]] == want
    assert all(r["args"]["schedule"] == "zb" and r["t1"] >= r["t0"] for r in spans)
    if engine == "scan":
        assert {r["args"]["mb"] for r in spans} == {-1}
    c = T.collector.TraceCollector(str(tmp_path))
    c.poll()
    doc = c.chrome("pipe")
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == 2 * n_ev
