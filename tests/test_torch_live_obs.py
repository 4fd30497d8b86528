"""The port's live observability plane (``obs.collector``, ``obs.server``,
``PlannerService.serve_metrics`` and the service CLI's ``metrics``,
``health`` and ``serve-metrics``) against ``repro``'s.

``repro``'s ``tests/test_live_obs.py`` runs on both packages, loaded as
``tests/test_torch_obs.py::load_variant`` loads a test file: the
subprocesses it starts run the package's own code. Then both packages'
``serve_metrics`` serve every endpoint with the same JSON keys over the same
telemetry and spool, and both CLIs' ``serve-metrics`` (a subprocess on port
0), ``metrics --url`` and ``health --url`` print the same keys. Every server
is stopped in a ``finally``; every wait is bounded.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_obs import NS, PKG_ROOTS, _chain_gg, _plan, keys_of, load_variant

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CLI_WAIT_S = 120                  # the CLI subprocess's startup line

for _pkg in PKG_ROOTS:
    load_variant("test_live_obs.py", _pkg, globals())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _seed_telemetry(ns, tele: str, spool_dir: str):
    """Two replayed runs into ``tele`` (run ids ``runA`` and ``runB``, the
    first spooled into ``spool_dir`` as ``runA``), and ``runA``'s predicted
    timeline."""
    plan, topo = _plan(ns, "1f1b")
    store = ns.telemetry.MeasurementStore(tele)
    spool = ns.collector.SpoolWriter(spool_dir, run_id="runA", name="train")
    for run in ("runA", "runB"):
        for step in range(3):
            rec, _ = ns.replay.execute_pipeline(
                plan, topo, schedule="1f1b", step=step, meta={"run_id": run},
                spool=spool if run == "runA" else None)
            store.append(rec)
    return ns.schedule.simulate_schedule(plan, topo, ns.schedule.make_schedule(
        "1f1b", plan.n_stages, plan.n_micro))


def _serve(pkg: str, root):
    """``serve_metrics`` of ``pkg``'s service over seeded telemetry and a
    spool, ``runA`` watched under its predicted timeline, one plan cached
    with the tracer on (a scrape drains the planner's spans into its shard);
    every endpoint's JSON (``/metrics`` parsed)."""
    ns = NS[pkg]
    svc_mod = __import__(f"{PKG_ROOTS[pkg]}.service.planner", fromlist=["PlannerService"])
    tele, spool_dir = str(root / "telemetry"), str(root / "spool")
    tl = _seed_telemetry(ns, tele, spool_dir)
    kw = {"device": "cpu"} if pkg == "port" else {}
    svc = svc_mod.PlannerService(cache_dir=str(root / "plans"), telemetry_dir=tele, **kw)
    old = ns.obs.set_tracer(ns.obs.Tracer(enabled=True))     # the planner's spans
    server = None
    try:
        resp = svc.plan_graph(_chain_gg(ns), ns.device.testbed(), iterations=4, seed=0)
        server = svc.serve_metrics(host="127.0.0.1", port=0, spool_dir=spool_dir,
                                   run_id="runA", recalibrate=False, slo_s=tl.makespan * 1.05)
        server.health.watch("runA", timeline=tl)
        base = server.url
        out = {"metrics": sorted(ns.obs.parse_prometheus_text(_get(base + "/metrics")))}
        for path in ("/healthz", "/plans", f"/plans/{resp.graph_fp}/verify", "/traces",
                     "/traces/runA", "/runs", "/runs/runA/health", "/alerts"):
            out[path.replace(resp.graph_fp, "<fp>")] = json.loads(_get(base + path))
        return out
    finally:
        if server is not None:
            server.stop()
        ns.obs.set_tracer(old)


def test_serve_metrics_serves_every_endpoint_as_repro(tmp_path):
    """Both packages' ``serve_metrics``: the same metric families, and each
    endpoint's JSON with the same keys; ``/runs`` lists both runs,
    ``/traces/runA`` holds the training shard and the planner's own, and
    ``/runs/runA/health`` is judged against the watched timeline."""
    got = {pkg: _serve(pkg, tmp_path / pkg) for pkg in PKG_ROOTS}
    r, t = got["repro"], got["port"]
    assert t["metrics"] == r["metrics"] and "run_health_step_ratio" in t["metrics"]
    for path in r:
        if path == "metrics":
            continue
        assert keys_of(t[path]) == keys_of(r[path]), path
    assert sorted(x["run_id"] for x in t["/runs"]["runs"]) == ["runA", "runB"]
    assert t["/runs/runA/health"]["mode"] == "predicted"
    assert t["/runs/runA/health"]["steps"] == r["/runs/runA/health"]["steps"] == 3
    doc = t["/traces/runA"]
    NS["port"].obs.validate_chrome_trace(doc)
    procs = {e["args"]["name"].split(" ")[0] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"train", "planner"}
    assert any(e["ph"] == "X" and e["name"].startswith("F0.") for e in doc["traceEvents"])


def _cli(pkg: str, argv: list) -> dict:
    main = __import__(f"{PKG_ROOTS[pkg]}.service.cli", fromlist=["main"]).main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _start_cli_server(pkg: str, root) -> tuple:
    """``python -m <pkg>.service.cli serve-metrics`` on port 0 over seeded
    telemetry and a spool; returns (process, its startup JSON)."""
    tele, spool_dir = str(root / "telemetry"), str(root / "spool")
    _seed_telemetry(NS[pkg], tele, spool_dir)
    argv = [sys.executable, "-m", f"{PKG_ROOTS[pkg]}.service.cli", "serve-metrics", "--port",
            "0", "--cache-dir", str(root / "plans"), "--telemetry-dir", tele, "--spool-dir",
            spool_dir, "--run-id", "runA", "--no-recalibrate", "--slo-ms", "1",
            "--duration", str(CLI_WAIT_S)]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    lines, deadline = [], time.time() + CLI_WAIT_S
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.rstrip() == "}":
            return proc, json.loads("".join(lines))
    proc.kill()
    raise AssertionError(f"no startup JSON: {''.join(lines)} {proc.stderr.read()[-2000:]}")


def test_cli_serve_metrics_metrics_and_health_url_as_repro(tmp_path):
    """Both CLIs: ``serve-metrics`` prints the same startup keys and
    endpoints; ``metrics --url`` reads a parseable exposition and the plan
    listing; ``health --url`` gives the same keys, both runs and the page
    that a 1 ms SLO fires (replayed steps take 1.8 ms)."""
    outs = {}
    for pkg in PKG_ROOTS:
        proc, start = _start_cli_server(pkg, tmp_path / pkg)
        try:
            rc, prom = _cli(pkg, ["metrics", "--url", start["url"]])
            assert rc == 0
            NS[pkg].obs.parse_prometheus_text(prom)
            rc, plans = _cli(pkg, ["metrics", "--url", start["url"], "--format", "json"])
            assert rc == 0
            rc, health = _cli(pkg, ["health", "--url", start["url"]])
            assert rc == 0
            outs[pkg] = (start, json.loads(plans), json.loads(health))
        finally:
            proc.kill()
            proc.wait(timeout=30)
    (rs, rp, rh), (ts, tp, th) = outs["repro"], outs["port"]
    assert ts["endpoints"] == rs["endpoints"]
    assert keys_of(ts) == keys_of(rs) and keys_of(tp) == keys_of(rp) and keys_of(th) == keys_of(rh)
    assert sorted(th["health"]) == ["runA", "runB"]
    assert any(a["rule"] == "slo_fast_burn" and a["state"] == "firing"
               for a in th["alerts"]["alerts"])


def test_cli_health_local_mode_as_repro(tmp_path):
    """``health --telemetry-dir`` on both packages over the same replayed
    records: the same summaries, alerts and per-run health."""
    outs = {}
    for pkg in PKG_ROOTS:
        tele = str(tmp_path / pkg / "telemetry")
        _seed_telemetry(NS[pkg], tele, str(tmp_path / pkg / "spool"))
        rc, out = _cli(pkg, ["health", "--telemetry-dir", tele, "--slo-ms", "1"])
        assert rc == 0
        out = json.loads(out)
        out.pop("telemetry_dir")
        out["stats"] = {k: v for k, v in out["stats"].items() if "seconds" not in k}
        for h in out["health"].values():
            h.pop("updated", None)
        outs[pkg] = out
    assert keys_of(outs["port"]) == keys_of(outs["repro"])
    states = {pkg: sorted((a["run_id"], a["rule"], a["severity"], a["state"])
                          for a in o["alerts"]) for pkg, o in outs.items()}
    assert states["port"] == states["repro"] and states["port"]
    assert outs["port"]["ingested"] == outs["repro"]["ingested"] == 6
