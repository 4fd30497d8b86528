"""The port's planner service (``repro_torch.service``) against ``repro``'s.

The port's ``service`` package is a copy of ``repro``'s with the imports
renamed, over the port's copy of the planner. On the same grouped graph
and topology both give the same fingerprints, byte-equal plan records,
stores that load in either package, and the same strategy, time, source
and stats from ``plan_graph``: cold, warm-started and cached. ``repro``'s
service tests (``tests/test_service.py``) run on both packages, and the
serve launcher's ``--plan-topo``/``--observe`` print ``repro``'s fields.
"""
import contextlib
import copy
import importlib
import io
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")

from test_torch_runtime import bert_grouped

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _ns(root: str):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    ns = SimpleNamespace(device=m("core.device"), sfb=m("core.sfb"), S=m("core.strategy"),
                         service=m("service"), planner=m("service.planner"),
                         store=m("service.store"), cli=m("service.cli"), root=root)
    ns.Service, ns.PlanStore, ns.PlanRecord = (ns.service.PlannerService,
                                               ns.service.PlanStore, ns.store.PlanRecord)
    return ns


PKGS = {"repro": _ns("repro"), "port": _ns("repro_torch")}
R, T = PKGS["repro"], PKGS["port"]


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def _gg(pkg, n_groups=12):
    return bert_grouped(n_groups)[pkg == "port"]


def _perturbed(topo, scale=0.9):
    t2 = copy.deepcopy(topo)
    t2.inter_bw = topo.inter_bw * scale
    return t2


def _dummy_record(ns, graph_fp="g" * 64, topo_fp="t" * 64, time=1.0):
    strat = ns.S.Strategy([ns.S.Action((0,), ns.S.Option.AR), None])
    return ns.PlanRecord(
        graph_fp=graph_fp, topo_fp=topo_fp, topo_struct_fp="s" * 64, n_groups=2, topo_m=1,
        strategy=strat.to_dict(), sfb_plans={"0": ns.sfb.GroupSFB(1.0, 2.0, 3.0, ["dot"]).to_dict()},
        time=time, baseline_time=2.0, meta={"seed": 0})


def _stats(svc):
    return {k: v for k, v in svc.stats().items() if k != "metrics"}


def _resp(r):
    return (r.strategy.canonical_json(), r.time, r.baseline_time, r.source, r.iterations_run,
            r.graph_fp, r.topo_fp, r.best_reward, r.policy, r.verify,
            {g: p.to_dict() for g, p in r.sfb_plans.items()})


# ------------------------------------------------------ cross-package parity

def test_fingerprints_equal():
    rsvc, tsvc = R.service, T.service
    for n in (10, 12):
        rgg, tgg = bert_grouped(n)
        assert rsvc.fingerprint_grouped(rgg) == tsvc.fingerprint_grouped(tgg)
        assert rsvc.fingerprint_graph(rgg.base) == tsvc.fingerprint_graph(tgg.base)
        assert rsvc.structural_features(rgg) == tsvc.structural_features(tgg)
    for name, make in R.cli.TOPOLOGIES.items():
        rt, tt = make(), T.cli.TOPOLOGIES[name]()
        assert rsvc.fingerprint_topology(rt) == tsvc.fingerprint_topology(tt), name
        assert rsvc.topology_structure_fingerprint(rt) \
            == tsvc.topology_structure_fingerprint(tt), name
        assert rsvc.fingerprint_topology(_perturbed(rt)) \
            == tsvc.fingerprint_topology(_perturbed(tt)), name


def test_plan_record_json_byte_equal_and_stores_cross_load(tmp_path):
    for a, b in ((R, T), (T, R)):
        rec = _dummy_record(a)
        assert json.dumps(rec.to_dict(), sort_keys=True) \
            == json.dumps(b.PlanRecord.from_dict(rec.to_dict()).to_dict(), sort_keys=True)
        d = tmp_path / a.root
        a.PlanStore(path=str(d)).put(rec)
        got = b.PlanStore(path=str(d)).get(rec.graph_fp, rec.topo_fp)
        assert got is not None and type(got) is b.PlanRecord
        assert got.strategy_obj().canonical_json() == rec.strategy_obj().canonical_json()
        # the file the other package rewrites is byte-identical
        fn = next(f for f in os.listdir(d) if f.endswith(".json"))
        before = (d / fn).read_bytes()
        b.PlanStore(path=str(d)).put(got)
        assert (d / fn).read_bytes() == before
    assert T.store.SCHEMA_VERSION == R.store.SCHEMA_VERSION


def _plan_sequence(ns, gg, topo, cache):
    svc = ns.Service(cache_dir=str(cache))
    out = [svc.plan_graph(gg, topo, iterations=10, seed=0),            # cold
           svc.plan_graph(gg, topo, iterations=10, seed=0),            # hit
           svc.plan_graph(gg, _perturbed(topo), iterations=10, seed=0),  # warm (topology)
           svc.plan_graph(gg, topo, iterations=14, seed=1)]            # warm (stale hit)
    again = ns.Service(cache_dir=str(cache)).plan_graph(gg, topo, iterations=14, seed=1)
    return out + [again], _stats(svc)


def _h100_as_repro(t_topo):
    """The port's ``h100_nodes()`` as a ``repro`` Topology with the same
    numbers (``repro`` has no H100 row), so that ``repro``'s planner can
    plan over the same cluster."""
    from repro.core import device as rd
    groups = []
    for g in t_topo.groups:
        rg = rd.DeviceGroup(g.group_id, "V100", g.num_gpus, intra_bw=g.intra_bw,
                            mem_bytes=g.mem_bytes, flops=g.flops)
        rg.gpu_type = g.gpu_type
        groups.append(rg)
    return rd.Topology(groups, t_topo.inter_bw.copy(), latency=t_topo.latency,
                       name=t_topo.name, coll_eff_cross=t_topo.coll_eff_cross,
                       coll_eff_intra=t_topo.coll_eff_intra, p2p_eff=t_topo.p2p_eff)


@pytest.mark.parametrize("topo", ["testbed", "h100"])
def test_plan_graph_gives_repro_plans_cold_warm_cached(topo, tmp_path):
    make = T.cli.TOPOLOGIES[topo]
    rtopo = _h100_as_repro(make()) if topo == "h100" else R.cli.TOPOLOGIES[topo]()
    rout, rst = _plan_sequence(R, _gg("repro"), rtopo, tmp_path / "r")
    tout, tst = _plan_sequence(T, _gg("port"), make(), tmp_path / "t")
    assert [r.source for r in tout] == ["cold", "hit", "warm", "warm", "hit"]
    assert [_resp(r) for r in rout] == [_resp(t) for t in tout]
    assert rst == tst


def test_plan_many_dedups_as_repro():
    outs = []
    for ns, pkg in ((R, "repro"), (T, "port")):
        svc = ns.Service()
        req = ns.planner.PlanRequest
        gg, topo = _gg(pkg), ns.device.testbed()
        res = svc.plan_many([req(gg, topo, iterations=8), req(gg, topo, iterations=8),
                             req(_gg(pkg, 10), topo, iterations=8), req(gg, topo, iterations=8)])
        outs.append(([_resp(r) for r in res], _stats(svc)))
    assert outs[0] == outs[1]
    assert [r[3] for r in outs[1][0]] == ["cold", "hit", "warm", "hit"]
    assert outs[1][1]["batch_dedup"] == 2


def test_h100_topology_is_accepted(tmp_path, capsys):
    topo = T.cli.TOPOLOGIES["h100"]()
    assert topo.name == "h100-2x8" and {g.gpu_type for g in topo.groups} == {"H100"}
    assert set(T.cli.TOPOLOGIES) == set(R.cli.TOPOLOGIES) | {"h100"}
    svc = T.Service(cache_dir=str(tmp_path))
    resp = svc.plan_graph(_gg("port"), topo, iterations=6, seed=0)
    assert resp.source == "cold" and resp.speedup > 0
    assert T.cli.main(["inspect", "--cache-dir", str(tmp_path)]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows["count"] == 1 and rows["records"][0]["topo_m"] == topo.m
    assert T.cli.main(["evict", "--cache-dir", str(tmp_path), "--all"]) == 0
    assert json.loads(capsys.readouterr().out) == {"evicted": 1, "remaining": 0}


_PLAN = re.compile(r"^plan\[(\w+)\] source=(\w+) iters=(\d+) time=([\d.]+)s "
                   r"speedup=([\d.]+) stats=(\{.*\})$", re.M)
_OBS = re.compile(r"^observe\[(\w+)\] step=([\d.]+)s kind=(\w+)( drift=[\d.]+)?"
                  r"( stale=[\d.]+s new=[\d.]+s improved=(True|False))?$", re.M)


def _serve(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_serve_plan_topo_observe_prints_repro_fields(tmp_path):
    from repro.launch import serve as rserve
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--prompt-len", "4", "--gen", "2",
            "--plan-topo", "testbed", "--plan-iters", "4", "--observe"]
    runs = {}
    for name, main, extra in (("repro", rserve.main, []), ("port", tserve.main,
                                                           ["--device", "cpu"])):
        d = tmp_path / name
        dirs = ["--plan-cache", str(d / "plans"), "--telemetry-dir", str(d / "telemetry")]
        runs[name] = [_serve(main, argv + extra + dirs) for _ in range(2)]
    for name, (first, second) in runs.items():
        p1, p2 = _PLAN.search(first), _PLAN.search(second)
        o1, o2 = _OBS.search(first), _OBS.search(second)
        assert p1 and p2 and o1 and o2, (name, first, second)
        assert (p1.group(1), p1.group(2), p1.group(3)) == ("testbed", "cold", "4")
        assert (p2.group(2), p2.group(3)) == ("hit", "0")          # served from the cache
        # the kind follows the measured step against the simulated one (a
        # host's speed); either way the drift is reported, a replan with its times
        for o in (o1, o2):
            assert o.group(3) in ("ok", "replanned") and o.group(4)
            assert bool(o.group(5)) == (o.group(3) == "replanned")
    # the same fields, and the same keys in the printed stats
    keys = [sorted(eval(_PLAN.search(runs[n][0]).group(6))) for n in ("repro", "port")]
    assert keys[0] == keys[1]
    from repro_torch.runtime.telemetry import MeasurementStore
    for n in ("repro", "port"):
        assert len(MeasurementStore(str(tmp_path / n / "telemetry"))) == 2


def test_serve_plan_topo_h100_runs_end_to_end(tmp_path):
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--plan-topo", "h100",
            "--observe", "--batch", "2", "--prompt-len", "4", "--gen", "2", "--plan-iters", "4",
            "--plan-cache", str(tmp_path / "plans"), "--telemetry-dir", str(tmp_path / "t")]
    first, second = _serve(tserve.main, argv), _serve(tserve.main, argv)
    assert _PLAN.search(first).group(2) == "cold" and _PLAN.search(second).group(2) == "hit"
    assert _OBS.search(first).group(1) == "h100"
    with pytest.raises(SystemExit, match="unknown --plan-topo"):
        tserve.main(argv[:8] + ["--plan-topo", "nowhere"])


# ------------------------------- repro's service tests, on both packages

def test_fingerprint_deterministic_and_sensitive(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    assert ns.service.fingerprint_grouped(gg) == ns.service.fingerprint_grouped(gg)
    assert ns.service.fingerprint_topology(topo) == ns.service.fingerprint_topology(topo)
    t2 = _perturbed(topo)
    assert ns.service.fingerprint_topology(t2) != ns.service.fingerprint_topology(topo)
    assert ns.service.topology_structure_fingerprint(t2) \
        == ns.service.topology_structure_fingerprint(topo)
    t3 = copy.deepcopy(topo)
    t3.groups[0].num_gpus += 1
    assert ns.service.topology_structure_fingerprint(t3) \
        != ns.service.topology_structure_fingerprint(topo)
    g2 = copy.deepcopy(gg)
    g2.base.name = "renamed"
    assert ns.service.fingerprint_grouped(g2) == ns.service.fingerprint_grouped(gg)


def test_fingerprint_stable_across_processes(pkg):
    ns = PKGS[pkg]
    code = textwrap.dedent(f"""
        from {ns.root}.core.device import testbed
        from {ns.root}.service import fingerprint_topology
        print(fingerprint_topology(testbed()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC, PYTHONHASHSEED="12345"),
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ns.service.fingerprint_topology(ns.device.testbed()) \
        == R.service.fingerprint_topology(R.device.testbed())


def test_store_memory_lru_and_disk_roundtrip(pkg, tmp_path):
    ns = PKGS[pkg]
    store = ns.PlanStore(capacity=2)
    for i in range(3):
        store.put(_dummy_record(ns, graph_fp=f"g{i}" + "0" * 62))
    assert len(store) == 2 and store.get("g0" + "0" * 62, "t" * 64) is None
    store = ns.PlanStore(path=str(tmp_path))
    rec = _dummy_record(ns)
    store.put(rec)
    got = ns.PlanStore(path=str(tmp_path)).get(rec.graph_fp, rec.topo_fp)
    assert got.strategy_obj().canonical_json() == rec.strategy_obj().canonical_json()
    sfb = got.sfb_objs()[0]
    assert (sfb.extra_flops, sfb.bcast_bytes, sfb.saved_sync_bytes, sfb.dup_op_types) \
        == (1.0, 2.0, 3.0, ["dot"])
    assert ns.PlanStore(path=str(tmp_path)).evict(graph_fp=rec.graph_fp[:16]) == 1
    assert ns.PlanStore(path=str(tmp_path)).get(rec.graph_fp, rec.topo_fp) is None


def _age(tmp_path, rec, t):
    fn = tmp_path / (rec.graph_fp[:24] + "-" + rec.topo_fp[:24] + ".json")
    os.utime(fn, (t, t))


def test_store_disk_eviction_budgets(pkg, tmp_path):
    ns = PKGS[pkg]
    now = 1_000_000.0
    d = tmp_path / "age"
    store = ns.PlanStore(path=str(d))
    for i in range(4):
        rec = _dummy_record(ns, graph_fp=f"g{i}" + "0" * 62,
                            topo_fp=("tA" if i < 3 else "tB") + "0" * 62)
        store.put(rec)
        _age(d, rec, now - 100 * (4 - i))
    assert store.evict_expired(max_age_s=250, now=now) == 2 and len(store) == 2
    store2 = ns.PlanStore(path=str(d))
    for i in range(4, 7):
        rec = _dummy_record(ns, graph_fp=f"g{i}" + "0" * 62, topo_fp="tA" + "0" * 62)
        store2.put(rec)
        _age(d, rec, now + i)
    assert store2.evict_expired(per_topo_quota=1, now=now + 10) >= 2
    assert store2.get("g6" + "0" * 62, "tA" + "0" * 62) is not None
    assert store2.get("g4" + "0" * 62, "tA" + "0" * 62) is None
    d = tmp_path / "size"
    store = ns.PlanStore(path=str(d))
    for i in range(3):
        rec = _dummy_record(ns, graph_fp=f"g{i}" + "0" * 62, topo_fp=f"t{i}" + "0" * 62)
        store.put(rec)
        _age(d, rec, now + i)
    one = os.path.getsize(next(d.glob("g*.json")))
    assert store.evict_expired(max_bytes=int(1.5 * one), now=now + 10) == 2
    assert store.get("g2" + "0" * 62, "t2" + "0" * 62) is not None
    store = ns.PlanStore(path=str(tmp_path / "quota"), per_topo_quota=2)
    for i in range(4):
        store.put(_dummy_record(ns, graph_fp=f"g{i}" + "0" * 62))
    assert len(store) <= 2


def test_store_budgets_cover_other_processes_records(pkg, tmp_path):
    ns = PKGS[pkg]
    writer_a, writer_b = ns.PlanStore(path=str(tmp_path)), ns.PlanStore(path=str(tmp_path))
    for i in range(3):
        writer_a.put(_dummy_record(ns, graph_fp=f"ga{i}" + "0" * 60))
    for i in range(2):
        writer_b.put(_dummy_record(ns, graph_fp=f"gb{i}" + "0" * 60))
    assert writer_b.evict_expired(per_topo_quota=1) == 4
    assert len(ns.PlanStore(path=str(tmp_path))) == 1
    writer_c = ns.PlanStore(path=str(tmp_path))
    writer_a.put(_dummy_record(ns, graph_fp="gz" + "0" * 62))
    assert writer_c.evict(all=True) == 2
    assert len(ns.PlanStore(path=str(tmp_path))) == 0


def test_store_concurrent_writers_share_disk_tier(pkg, tmp_path):
    ns = PKGS[pkg]
    stores = [ns.PlanStore(path=str(tmp_path)) for _ in range(3)]

    def hammer(s, base):
        for i in range(10):
            s.put(_dummy_record(ns, graph_fp=f"g{base}_{i}" + "0" * 56))

    threads = [threading.Thread(target=hammer, args=(s, k)) for k, s in enumerate(stores)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert os.path.exists(tmp_path / ".lock")
    assert len(ns.PlanStore(path=str(tmp_path))) == 30
    assert stores[0].get("g2_9" + "0" * 56, "t" * 64) is not None


def test_store_rejects_stale_schema(pkg, tmp_path):
    ns = PKGS[pkg]
    ns.PlanStore(path=str(tmp_path)).put(_dummy_record(ns))
    fn = next(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    d = json.load(open(tmp_path / fn))
    d["version"] = ns.store.SCHEMA_VERSION + 1
    json.dump(d, open(tmp_path / fn, "w"))
    assert len(ns.PlanStore(path=str(tmp_path))) == 0


def test_strategy_serialization_and_adapt(pkg):
    ns = PKGS[pkg]
    A, O, S = ns.S.Action, ns.S.Option, ns.S.Strategy
    strat = S([A((0, 2), O.PS), None, A((1,), O.PIPE)])
    back = S.from_dict(strat.to_dict())
    assert back.canonical_json() == strat.canonical_json()
    assert back.actions[0] == strat.actions[0] and back.actions[1] is None
    small = ns.device.Topology([ns.device.DeviceGroup(0, "V100", 2, intra_bw=1e9)],
                               ns.device._full_inter(1, 0))
    got = ns.service.adapt_strategy(S([A((0, 5), O.AR), A((6,), O.PS)]), 3, small)
    assert got.actions == [A((0,), O.AR), None, None]


def test_hit_is_byte_identical_and_runs_no_mcts(pkg, tmp_path):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    svc = ns.Service(cache_dir=str(tmp_path))
    r1 = svc.plan_graph(gg, topo, iterations=10, seed=0)
    r2 = svc.plan_graph(gg, topo, iterations=10, seed=0)
    assert r1.source == "cold" and r2.source == "hit" and r2.iterations_run == 0
    assert r2.strategy.canonical_json() == r1.strategy.canonical_json()
    r3 = ns.Service(cache_dir=str(tmp_path)).plan_graph(gg, topo, iterations=10, seed=0)
    assert r3.source == "hit" and r3.iterations_run == 0
    assert r3.strategy.canonical_json() == r1.strategy.canonical_json()


def test_warm_start_fewer_iters_no_worse_makespan(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    topo_p, budget = _perturbed(topo), 25
    cold = ns.Service().plan_graph(gg, topo_p, iterations=budget, seed=0)
    assert cold.iterations_run == budget
    svc = ns.Service()
    svc.plan_graph(gg, topo, iterations=budget, seed=0)
    warm = svc.plan_graph(gg, topo_p, iterations=budget, seed=0, stop_reward=cold.best_reward)
    assert warm.source == "warm" and warm.iterations_run < cold.iterations_run
    assert warm.time <= cold.time * (1 + 1e-9) and svc.stats()["warm"] == 1


def test_bigger_budget_not_shadowed_by_small_cached_plan(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    svc = ns.Service()
    svc.plan_graph(gg, topo, iterations=2, seed=0)
    big = svc.plan_graph(gg, topo, iterations=6, seed=0)
    assert big.source == "warm" and big.iterations_run > 0
    again = svc.plan_graph(gg, topo, iterations=6, seed=0)
    assert again.source == "hit" and again.iterations_run == 0


def test_serve_metrics_names_its_roadmap_item(tmp_path):
    """ROADMAP queue 1, item 6 is done: ``serve_metrics`` builds ``repro``'s
    server (unstarted here) with its collector, spool, health analyzer and
    recalibration loop; ``tests/test_torch_live_obs.py`` serves it."""
    server = T.Service(cache_dir=str(tmp_path)).serve_metrics(
        port=0, spool_dir=str(tmp_path / "spool"), start=False)
    assert type(server).__module__ == "repro_torch.obs.server"
    assert None not in (server.collector, server.spool, server.health, server.recalib)
