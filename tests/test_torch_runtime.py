"""The port's runtime feedback (``repro_torch.runtime``) against ``repro``'s.

The port's ``calibration``, ``drift``, ``executor`` and ``feedback`` are
copies of ``repro.runtime``'s and ``telemetry`` is finished here, so on the
same records both give the same profiles, drift reports, replay records and
replanned strategies (1e-9 relative for every number). ``repro``'s runtime
tests (``tests/test_runtime.py``, and the incremental-reader and
recalibration-poll tests of ``tests/test_obs.py`` and
``tests/test_live_obs.py``) run on both packages.
"""
import copy
import dataclasses
import functools
import importlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import torch

from test_torch_planner import to_port, to_port_strategy

REL = 1e-9


def _ns(root: str):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    ns = SimpleNamespace(
        compiler=m("core.compiler"), device=m("core.device"), features=m("core.features"),
        profiler=m("core.profiler"), simulator=m("core.simulator"), S=m("core.strategy"),
        rt=m("runtime"), calibration=m("runtime.calibration"), telemetry=m("runtime.telemetry"),
        feedback=m("runtime.feedback"), service=m("service"))
    ns.Service = ns.service.PlannerService
    return ns


PKGS = {"repro": _ns("repro"), "port": _ns("repro_torch")}
R, T = PKGS["repro"], PKGS["port"]


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


@functools.lru_cache(maxsize=None)
def _bert():
    """bert_small traced by ``jax_export`` at the zoo's batch, as ``repro``'s
    service, runtime and registry tests trace it (never mutated)."""
    from repro.core.jax_export import trace_training_graph
    from repro.core.zoo import build
    return trace_training_graph(*build("bert_small"), "bert")


@functools.lru_cache(maxsize=None)
def bert_grouped(n_groups: int):
    """(repro's, the port's) grouped bert_small: the same traced graph,
    simplified and partitioned by each package's planner."""
    from repro.core import graph as r_graph, partition as r_partition
    from repro_torch.core import graph as t_graph, partition as t_partition
    rg, tg = copy.deepcopy(_bert()).simplify(), to_port(_bert()).simplify()
    return (r_graph.group_graph(rg, r_partition.partition(rg, n_groups)),
            t_graph.group_graph(tg, t_partition.partition(tg, n_groups)))


def _gg(pkg):
    return bert_grouped(10)[pkg == "port"]


def _same(a, b, rel=REL, path="."):
    """Equal structure; numbers within ``rel`` of each other."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same(x, y, rel, f"{path}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isnan(a):
            assert str(a) == str(b), path
        else:
            assert b == pytest.approx(a, rel=rel, abs=1e-300), path
    else:
        assert a == b, path


def _true_cluster(topo, util_scale=0.5, cross_scale=0.25, lat_scale=3.0):
    t2 = copy.deepcopy(topo)
    for g in t2.groups:
        g.flops *= util_scale
    t2.coll_eff_cross *= cross_scale
    t2.p2p_eff *= 0.8
    t2.latency *= lat_scale
    return t2


def _toy_taskgraph(ns):
    """Hand-built TaskGraph exercising every task kind (no tracing)."""
    tg = ns.compiler.TaskGraph()
    for d in range(6):
        tg.add(kind="compute", group=0, device=d, flops=1e9 * (d + 1))
    tg.add(kind="xfer", group=0, src=0, dst=5, nbytes=3e6, deps=[0])
    tg.add(kind="xfer", group=0, src=1, dst=4, nbytes=9e6, deps=[1])
    tg.add(kind="allreduce", group=0, nbytes=8e6, devices=tuple(range(4)), deps=[6])
    tg.add(kind="allreduce", group=0, nbytes=24e6, devices=(0, 1, 2), deps=[7])
    tg.add(kind="allreduce", group=0, nbytes=2e6, devices=(0, 4, 5), deps=[8])
    tg.add(kind="ps", group=0, nbytes=6e6, devices=(0, 1, 4, 5), deps=[9])
    return tg


def _pair_records(ns, topo, true_eff: dict, n: int = 10):
    recs = []
    for i in range(n):
        colls = []
        for (gi, gj), eff in true_eff.items():
            nb = 1e6 * (1 + i % 3)
            colls.append({
                "kind": "xfer", "nbytes": nb, "n_dev": 2,
                "nominal_bw": topo.nominal_bw(gi, gj), "link": "p2p", "pair": f"{gi}-{gj}",
                "time": ns.profiler.transfer_time(nb, topo.nominal_bw(gi, gj) * eff,
                                                  topo.latency)})
        recs.append(ns.telemetry.StepRecord(collectives=colls, step=i))
    return recs


def _port_rec(rec):
    """A ``repro`` StepRecord as the port's, through its JSON form."""
    return T.telemetry.StepRecord.from_dict(json.loads(json.dumps(rec.to_dict())))


def _records(ns, noise=0.01, n=6):
    topo = ns.device.testbed()
    tg = _toy_taskgraph(ns)
    return [ns.rt.execute_plan(tg, _true_cluster(topo), nominal_topo=topo, step=i,
                               noise=noise, seed=i) for i in range(n)]


def _strip_ts(d):
    return {k: v for k, v in d.items() if k != "ts"}


def _stats(svc):
    return {k: v for k, v in svc.stats().items() if k != "metrics"}


# ------------------------------------------------------ cross-package parity

def test_execute_plan_gives_repro_records():
    for noise in (0.0, 0.01):
        for r, t in zip(_records(R, noise), _records(T, noise), strict=True):
            _same(_strip_ts(r.to_dict()), _strip_ts(t.to_dict()))
    # on a traced graph, with pair keys and per-op tags
    rgg, tgg, topo = _gg("repro"), _gg("port"), R.device.testbed()
    strat = R.S.Strategy([R.S.Action((0, 1), R.S.Option.PS)] * rgg.n)
    rtg = R.compiler.compile_strategy(rgg, strat, topo)
    ttg = T.compiler.compile_strategy(tgg, to_port_strategy(strat), T.device.testbed())
    rrec = R.rt.execute_plan(rtg, topo, gg=rgg, noise=0.05, seed=3)
    trec = T.rt.execute_plan(ttg, T.device.testbed(), gg=tgg, noise=0.05, seed=3)
    _same(_strip_ts(rrec.to_dict()), _strip_ts(trec.to_dict()))


def test_fit_profile_and_uniform_profile_give_repro_values():
    rrecs = _records(R) + _pair_records(R, R.device.testbed(), {(0, 1): 0.2, (0, 2): 0.45})
    trecs = [_port_rec(r) for r in rrecs]
    for kw in ({}, {"min_pair_samples": 4}):
        rp = R.rt.fit_profile(rrecs, R.device.testbed(), **kw)
        tp = T.rt.fit_profile(trecs, T.device.testbed(), **kw)
        _same(rp.to_dict(), tp.to_dict())
        rt_, tt_ = rp.apply(R.device.testbed()), tp.apply(T.device.testbed())
        _same([g.flops for g in rt_.groups], [g.flops for g in tt_.groups])
        _same(R.simulator.simulate(_toy_taskgraph(R), rt_).makespan,
              T.simulator.simulate(_toy_taskgraph(T), tt_).makespan)
    for scale in (0.5, 1.7):
        _same(R.rt.uniform_profile(R.device.testbed(), scale, n_records=3).to_dict(),
              T.rt.uniform_profile(T.device.testbed(), scale, n_records=3).to_dict())


def test_drift_detector_gives_repro_reports():
    rng = np.random.default_rng(0)
    rd = R.rt.DriftDetector(threshold=0.25, alpha=0.3, min_samples=2)
    td = T.rt.DriftDetector(threshold=0.25, alpha=0.3, min_samples=2)
    for i in range(40):
        key = ("g", f"t{i % 3}")
        sim, obs = float(rng.uniform(0.5, 2)), float(rng.uniform(0.2, 4))
        _same(rd.update(*key, sim, obs).to_dict(), td.update(*key, sim, obs).to_dict())
        if i % 7 == 6:
            rd.reset(*key)
            td.reset(*key)


def test_observed_sim_result_gives_repro_values():
    rrecs = [R.telemetry.StepRecord(wall_time=w, device_busy={"0": 0.5 * w, "3": 0.2 * w},
                                    link_busy={"0-1": 0.25 * w, "1-2": 0.1 * w})
             for w in (1.0, 2.0, 3.0, 7.5)]
    ro = R.rt.observed_sim_result(rrecs, R.device.testbed())
    to = T.rt.observed_sim_result([_port_rec(r) for r in rrecs], T.device.testbed())
    _same(dataclasses.asdict(ro), dataclasses.asdict(to))
    assert type(to) is T.simulator.SimResult
    assert to.link_idle_frac(1, 2) == ro.link_idle_frac(1, 2)


def _plan_and_observe(ns, gg, tmp_path):
    topo = ns.device.testbed()
    svc = ns.Service(drift_threshold=0.25, telemetry_dir=str(tmp_path))
    resp = svc.plan_graph(gg, topo, iterations=6, seed=0)
    tg = ns.compiler.compile_strategy(gg, resp.strategy, topo, sfb_plans=resp.sfb_plans)
    rec = ns.rt.execute_plan(tg, _true_cluster(topo), nominal_topo=topo, noise=0.01, seed=1)
    out = [svc.observe(gg, topo, rec, iterations=6)]
    out.append(svc.observe(gg, topo, out[0].response.time * 1.02, iterations=6))
    out.append(svc.observe(gg, topo, resp.time * 3.0, iterations=6))   # a bare time
    return resp, out, svc


def test_feedback_observe_gives_repro_kind_report_and_replan(tmp_path):
    rresp, rout, rsvc = _plan_and_observe(R, _gg("repro"), tmp_path / "r")
    tresp, tout, tsvc = _plan_and_observe(T, _gg("port"), tmp_path / "t")
    assert rresp.strategy.canonical_json() == tresp.strategy.canonical_json()
    assert [r.kind for r in rout] == [t.kind for t in tout] == ["replanned", "ok", "replanned"]
    for r, t in zip(rout, tout, strict=True):
        _same(r.report.to_dict(), t.report.to_dict())
        _same(r.observed, t.observed)
        if r.kind != "replanned":
            continue
        assert r.response.source == t.response.source == "warm"
        assert r.response.strategy.canonical_json() == t.response.strategy.canonical_json()
        _same([r.response.time, r.response.baseline_time, r.stale_time, r.improved],
              [t.response.time, t.response.baseline_time, t.stale_time, t.improved])
        _same(r.profile.to_dict(), t.profile.to_dict())
    assert _stats(rsvc) == _stats(tsvc)
    # each package's log reads in the other's store
    for a, b in ((tmp_path / "r", T), (tmp_path / "t", R)):
        other = R if b is T else T
        mine = [_strip_ts(x.to_dict()) for x in other.telemetry.MeasurementStore(str(a)).records()]
        theirs = [_strip_ts(x.to_dict()) for x in b.telemetry.MeasurementStore(str(a)).records()]
        assert mine == theirs and len(mine) == 3


def _poll(ns, gg, tmp_path):
    tele = str(tmp_path / "telemetry")
    svc = ns.Service(cache_dir=str(tmp_path / "plans"), telemetry_dir=tele)
    topo = ns.device.testbed()
    res = svc.plan_graph(gg, topo, iterations=8, seed=0)
    loop = ns.feedback.RecalibrationLoop(svc, interval_s=60.0, iterations=8)
    key = loop.watch(gg, topo)
    ext = ns.telemetry.MeasurementStore(tele)
    ext.append(ns.telemetry.StepRecord(graph_fp=key[0], topo_fp=key[1], step=0,
                                       wall_time=res.time * 3.0))
    before = len(svc.measurements.records())
    first = loop.poll_once()
    assert len(svc.measurements.records()) == before
    second = loop.poll_once()
    ext.append(ns.telemetry.StepRecord(graph_fp="other", topo_fp="other", wall_time=1.0))
    third = loop.poll_once()
    st = loop.stats()
    return key, [first, second, third], st, svc


def test_recalibration_poll_once_behaves_as_repro(tmp_path):
    rkey, rpolls, rst, rsvc = _poll(R, _gg("repro"), tmp_path / "r")
    tkey, tpolls, tst, tsvc = _poll(T, _gg("port"), tmp_path / "t")
    assert rkey == tkey
    assert [[x.kind for x in p] for p in rpolls] == [[x.kind for x in p] for p in tpolls] \
        == [["replanned"], [], []]
    r, t = rpolls[0][0], tpolls[0][0]
    assert r.response.strategy.canonical_json() == t.response.strategy.canonical_json()
    _same(r.report.to_dict(), t.report.to_dict())
    for k in ("records", "polls", "watched", "backlog_depth", "shed_total", "last_order"):
        assert rst[k] == tst[k], k
    assert rst["records"]["replanned"] == 1 and rst["records"]["unwatched"] == 1
    gauges = {k: v for k, v in tsvc.metrics.to_dict().items() if k.startswith("calib_")}
    assert gauges == {k: v for k, v in rsvc.metrics.to_dict().items() if k.startswith("calib_")}


# -------------------------------- repro's runtime tests, on both packages

def test_fit_primitives_recover_ground_truth(pkg):
    P = PKGS[pkg].profiler
    peak, true_u = 10e12, 0.37
    flops = np.array([1e9, 5e9, 2e10, 8e10])
    assert P.fit_utilization(flops, P.OP_OVERHEAD + flops / (peak * true_u), peak) \
        == pytest.approx(true_u)
    b_nom, true_eff, true_alpha = 12.5e9, 0.15, 2e-4
    sizes = np.array([1e6, 4e6, 1.6e7, 6.4e7])
    n_dev = np.array([4, 8, 4, 16])
    s = 2 * (n_dev - 1) / n_dev * sizes / b_nom
    fit = P.fit_comm(s, 2.0 * n_dev, s / true_eff + 2.0 * n_dev * true_alpha)
    assert fit.eff == pytest.approx(true_eff) and fit.alpha == pytest.approx(true_alpha)
    fit = P.fit_comm([1e-3], [2.0], [1e-2], prior_alpha=50e-6)
    assert fit.alpha == 50e-6 and 1e-3 / fit.eff + 2.0 * fit.alpha == pytest.approx(1e-2)


def test_degenerate_fits_return_none_not_peak_speed(pkg):
    ns = PKGS[pkg]
    P = ns.profiler
    assert P.fit_utilization([1e9, 2e9], [P.OP_OVERHEAD, P.OP_OVERHEAD], 10e12) is None
    assert P.fit_comm([1e-3, 2e-3], [2.0, 2.0], [1e-5, 1e-5], prior_alpha=50e-6) is None
    rec = ns.telemetry.StepRecord(
        compute=[{"gpu_type": "V100", "flops": 1e9, "time": P.OP_OVERHEAD}],
        collectives=[{"kind": "allreduce", "nbytes": 1e6, "n_dev": 4, "nominal_bw": 12.5e9,
                      "link": "cross", "time": 1e-9}])
    prof = ns.rt.fit_profile([rec], ns.device.testbed())
    assert prof.util == {} and prof.links == {}


def test_calibration_recovers_perturbed_cluster(pkg):
    ns = PKGS[pkg]
    topo = ns.device.testbed()
    true, tg = _true_cluster(topo), _toy_taskgraph(ns)
    profile = ns.rt.fit_profile(
        [ns.rt.execute_plan(tg, true, nominal_topo=topo, step=i) for i in range(2)], topo)
    for t, u in profile.util.items():
        assert u == pytest.approx(ns.device.GPU_PEAKS[t]["util"] * 0.5, rel=1e-6)
    assert profile.links["cross"].eff == pytest.approx(true.coll_eff_cross, rel=1e-6)
    assert profile.links["cross"].alpha == pytest.approx(true.latency, rel=1e-6)
    obs = ns.simulator.simulate(tg, true).makespan
    calib = ns.simulator.simulate(tg, topo, profile=profile).makespan
    assert calib == pytest.approx(obs, rel=1e-9)
    assert ns.simulator.simulate(tg, profile.apply(topo)).makespan \
        == pytest.approx(calib, rel=1e-12)


def test_calibration_closes_error_2x(pkg):
    ns = PKGS[pkg]
    topo, tg = ns.device.testbed(), _toy_taskgraph(ns)
    recs = _records(ns)
    obs = float(np.median([r.wall_time for r in recs]))
    err_before = abs(ns.simulator.simulate(tg, topo).makespan - obs) / obs
    profile = ns.rt.fit_profile(recs, topo)
    err_after = abs(ns.simulator.simulate(tg, topo, profile=profile).makespan - obs) / obs
    assert err_before >= 2.0 * err_after


def test_profile_serialization_roundtrip(pkg, tmp_path):
    ns = PKGS[pkg]
    topo = ns.device.testbed()
    profile = ns.rt.fit_profile(_records(ns, 0.0, 1), topo)
    p = str(tmp_path / "profile.json")
    profile.save(p)
    back = ns.calibration.CalibrationProfile.load(p)
    assert back.util == profile.util and back.latency == profile.latency
    assert {k: v.to_dict() for k, v in back.links.items()} \
        == {k: v.to_dict() for k, v in profile.links.items()}
    with pytest.raises(ValueError):
        ns.calibration.CalibrationProfile.from_dict({"version": 99})
    # a profile saved by one package loads in the other
    other = T if ns is R else R
    assert other.rt.load_profile(p).to_dict() == back.to_dict()


def test_uniform_profile_scales_makespan_exactly(pkg):
    ns = PKGS[pkg]
    topo, tg = ns.device.testbed(), _toy_taskgraph(ns)
    base = ns.simulator.simulate(tg, topo).makespan
    half = ns.simulator.simulate(tg, topo, profile=ns.rt.uniform_profile(topo, 0.5)).makespan
    assert half == pytest.approx(2.0 * base, rel=1e-2)


def test_observe_time_only_falls_back_to_uniform_calibration(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    svc = ns.Service(drift_threshold=0.25)
    resp = svc.plan_graph(gg, topo, iterations=6, seed=0)
    res = svc.observe(gg, topo, resp.time * 2.0, iterations=6)
    assert res.kind == "replanned"
    assert res.profile.meta.get("uniform_scale") == pytest.approx(0.5)
    assert res.stale_time == pytest.approx(resp.time * 2.0, rel=1e-3)


def test_measurement_store_jsonl_roundtrip(pkg, tmp_path):
    tm = PKGS[pkg].telemetry
    store = tm.MeasurementStore(str(tmp_path))
    for i in range(3):
        store.append(tm.StepRecord(graph_fp="g1", topo_fp=f"t{i % 2}", step=i,
                                   wall_time=0.1 * (i + 1)))
    store2 = tm.MeasurementStore(str(tmp_path))
    assert len(store2) == 3
    assert [r.step for r in store2.records(topo_fp="t0")] == [0, 2]
    assert [r.step for r in store2.records(limit=1)] == [2]
    assert store2.records()[0].wall_time == pytest.approx(0.1)
    assert [r.step for r in store2.tail(2, block_size=16)] == [1, 2]


def test_read_new_incremental_torn_line_and_truncation(pkg, tmp_path):
    tm = PKGS[pkg].telemetry

    def rec(i, fp="g"):
        return tm.StepRecord(graph_fp=fp, topo_fp="t", step=i, wall_time=0.1)

    store = tm.MeasurementStore(str(tmp_path))
    for i in range(3):
        store.append(rec(i))
    assert [r.step for r in store.read_new()] == [0, 1, 2]
    assert store.read_new() == []
    store.append(rec(3))
    store.append(rec(4, fp="other"))
    assert [r.step for r in store.read_new(graph_fp="g")] == [3]
    assert store.read_new() == []
    with open(store.path, "a") as f:        # a torn in-flight append stays buffered
        f.write('{"graph_fp": "g", "step": 5')
    assert store.read_new() == []
    with open(store.path, "a") as f:
        f.write(', "wall_time": 0.5}\n')
    assert [r.step for r in store.read_new()] == [5]
    with open(store.path, "w") as f:        # truncation resets the cursor
        f.write("")
    store.append(rec(9))
    assert [r.step for r in store.read_new()] == [9]
    mem = tm.MeasurementStore()
    for i in range(5):
        mem.append(rec(i))
    assert [r.step for r in mem.tail(2)] == [3, 4] and len(mem.read_new()) == 5
    assert mem.read_new() == []


def test_step_timer_records_wall_times(pkg):
    tm = PKGS[pkg].telemetry
    store = tm.MeasurementStore()
    timer = tm.StepTimer(store, graph_fp="g", topo_fp="t", meta={"launcher": "test"})
    fn = timer.wrap(lambda x: x + 1)
    assert fn(1) == 2 and fn(2) == 3
    recs = store.records()
    assert len(store) == 2 and all(r.wall_time > 0 for r in recs)
    assert recs[1].step == 1 and recs[0].meta["launcher"] == "test"
    assert timer.summary()["steps"] == 2
    if pkg == "port":                        # tensors pass through, on the CPU unsynchronized
        assert timer.wrap(lambda t: t * 2)(torch.ones(2)).tolist() == [2.0, 2.0]


def test_observed_sim_result_aggregates(pkg):
    ns = PKGS[pkg]
    recs = [ns.telemetry.StepRecord(wall_time=w, device_busy={"0": 0.5 * w},
                                    link_busy={"0-1": 0.25 * w}) for w in (1.0, 2.0, 3.0)]
    res = ns.rt.observed_sim_result(recs, ns.device.testbed())
    assert res.makespan == 2.0 and res.device_busy[0] == pytest.approx(1.0)
    assert res.link_idle_frac(0, 1) == pytest.approx(1 - 0.5 / 2.0)
    with pytest.raises(ValueError):
        ns.rt.observed_sim_result([], ns.device.testbed())


def test_featurize_uses_observed_feedback(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    strat = ns.S.Strategy([ns.S.data_parallel_all(topo)] * gg.n)
    res = ns.simulator.simulate(ns.compiler.compile_strategy(gg, strat, topo), topo)
    W = res.makespan * 3.0
    observed = ns.rt.observed_sim_result(
        [ns.telemetry.StepRecord(wall_time=W, device_busy={"0": 0.1 * W})], topo)
    het_sim = ns.features.featurize(gg, topo, strat, res, 0)
    het_obs = ns.features.featurize(gg, topo, strat, res, 0, observed=observed)
    assert het_obs.dev_x[0, 5] != pytest.approx(float(het_sim.dev_x[0, 5]))
    bare = ns.rt.observed_sim_result([ns.telemetry.StepRecord(wall_time=W)], topo)
    het_bare = ns.features.featurize(gg, topo, strat, res, 0, observed=bare)
    np.testing.assert_allclose(het_bare.dev_x[:, 5], het_sim.dev_x[:, 5])
    np.testing.assert_allclose(het_bare.dd_e[:, :, 1], het_sim.dd_e[:, :, 1])
    np.testing.assert_allclose(het_obs.op_x[:, 7], het_sim.op_x[:, 7])
    np.testing.assert_allclose(het_obs.op_x[:, 8], het_sim.op_x[:, 8])
    np.testing.assert_allclose(het_obs.dev_x[:, 4], het_sim.dev_x[:, 4])
    assert het_obs.op_x[:, 7].max() > 0


def test_drift_detector(pkg):
    DD = PKGS[pkg].rt.DriftDetector
    det = DD(threshold=0.25, alpha=0.5, min_samples=1)
    ok = det.update("g", "t", 1.0, 1.1)
    assert not ok.drifted and ok.drift == pytest.approx(0.1)
    bad = det.update("g", "t", 1.0, 2.1)
    assert bad.drifted and bad.ewma == pytest.approx(1.6)
    det.reset("g", "t")
    assert det.update("g", "t", 1.0, 1.1).n_obs == 1
    det = DD(threshold=0.25, min_samples=2)
    assert not det.update("g", "t", 1.0, 5.0).drifted
    assert det.update("g", "t", 1.0, 5.0).drifted


def test_observe_below_threshold_and_without_plan(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    svc = ns.Service(drift_threshold=0.25)
    assert svc.observe(gg, topo, 1.0).kind == "no_plan" and len(svc.measurements) == 1
    resp = svc.plan_graph(gg, topo, iterations=6, seed=0)
    res = svc.observe(gg, topo, resp.time * 1.1)
    assert res.kind == "ok" and not res.report.drifted
    assert svc.store.get(resp.graph_fp, resp.topo_fp) is not None
    assert svc.stats()["replans"] == 0


def test_observe_drift_evicts_and_replans(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    svc = ns.Service(drift_threshold=0.25)
    resp = svc.plan_graph(gg, topo, iterations=6, seed=0)
    tg = ns.compiler.compile_strategy(gg, resp.strategy, topo, sfb_plans=resp.sfb_plans)
    rec = ns.rt.execute_plan(tg, _true_cluster(topo), nominal_topo=topo)
    assert rec.wall_time > resp.time * 1.25
    res = svc.observe(gg, topo, rec, iterations=6)
    assert res.kind == "replanned" and res.report.drifted
    assert (res.response.graph_fp, res.response.topo_fp) == (resp.graph_fp, resp.topo_fp)
    refreshed = svc.store.get(resp.graph_fp, resp.topo_fp)
    assert refreshed.time == pytest.approx(res.response.time)
    assert refreshed.time != pytest.approx(resp.time)
    assert res.response.source == "warm"
    assert svc.observe(gg, topo, res.response.time * 1.02, iterations=6).kind == "ok"
    assert res.response.time <= res.stale_time * (1 + 1e-9) and res.improved
    assert ns.simulator.simulate(tg, res.profile.apply(topo)).makespan \
        == pytest.approx(rec.wall_time, rel=1e-6)
    assert svc.stats()["replans"] == 1 and svc.stats()["observations"] == 2


def test_per_pair_calibration(pkg, tmp_path):
    ns = PKGS[pkg]
    topo = ns.device.testbed()
    true_eff = {(0, 1): 0.2, (0, 2): 0.45}
    prof = ns.rt.fit_profile(_pair_records(ns, topo, true_eff), topo, min_pair_samples=8)
    assert set(prof.pairs) == {"0-1", "0-2"}
    for (gi, gj), eff in true_eff.items():
        assert prof.pairs[f"{gi}-{gj}"].eff == pytest.approx(eff, rel=1e-6)
    t2 = prof.apply(topo)
    assert t2.bw(0, 1) == pytest.approx(topo.nominal_bw(0, 1) * 0.2, rel=1e-6)
    assert t2.bw(1, 2) == pytest.approx(topo.nominal_bw(1, 2) * t2.p2p_eff, rel=1e-6)
    sparse = ns.rt.fit_profile(_pair_records(ns, topo, {(0, 1): 0.2}, n=5), topo,
                               min_pair_samples=8)
    assert sparse.pairs == {} and sparse.meta["pair_samples"] == {"0-1": 5}
    assert sparse.links["p2p"].eff == pytest.approx(0.2, rel=1e-6)
    p = str(tmp_path / "prof.json")
    prof.save(p)
    back = ns.calibration.CalibrationProfile.load(p)
    assert back.pairs["0-1"].eff == pytest.approx(prof.pairs["0-1"].eff, rel=1e-12)
    assert back.apply(ns.device.testbed()).pair_eff


def test_executor_records_pair_keys(pkg):
    ns, gg = PKGS[pkg], _gg(pkg)
    topo = ns.device.testbed()
    strat = ns.S.Strategy([ns.S.Action((0, 1), ns.S.Option.PS)] * gg.n)
    rec = ns.rt.execute_plan(ns.compiler.compile_strategy(gg, strat, topo), topo)
    xfers = [c for c in rec.collectives if c["kind"] == "xfer"]
    assert xfers and all("pair" in c for c in xfers)


def test_calibrate_cli_fits_the_h100_row(tmp_path, capsys):
    """The port's ``calibrate`` on pipeline-engine telemetry: compute samples
    tagged ``"H100"`` fit the H100 row's utilization."""
    from repro_torch.service import cli
    peak = T.device.peak_flops("H100")
    store = T.telemetry.MeasurementStore(str(tmp_path))
    for i in range(4):
        store.append(T.telemetry.StepRecord(compute=[
            {"gpu_type": "H100", "flops": 1e12 * (k + 1),
             "time": T.profiler.OP_OVERHEAD + 1e12 * (k + 1) / (peak * 0.31), "op": "F"}
            for k in range(3)], step=i))
    assert cli.main(["calibrate", "--topo", "h100", "--telemetry-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["records"] == 4 and out["profile"]["util"]["H100"] == pytest.approx(0.31)
