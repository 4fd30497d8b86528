"""Run health: continuous executed-vs-predicted attribution per run.

``obs.trace.diff_report`` answers "where did my predicted step go" for ONE
executed step, offline. ``RunHealthAnalyzer`` lifts that join into a
continuously-maintained, served surface: it drains ``StepRecord``s from
a telemetry ``MeasurementStore`` (``read_new()``, the same incremental
cursor the ``RecalibrationLoop`` polls) and rolls, per run:

  * per-stage compute and per-(src,dst) transfer **residual ratios** —
    EWMA-smoothed executed busy seconds against the registered predicted
    schedule ``Timeline`` (or, for unregistered runs, against a baseline
    captured from the run's own first steps: *self-baselined* mode);
  * executed vs predicted **bubble fraction**;
  * **straggler ranking** — top-k stages/links by slowdown normalized
    against the run's median ratio (a uniform slowdown is drift, not a
    straggler), with persistence hysteresis so one noisy step neither
    flags nor clears a straggler;
  * a **step-time SLO** with multi-window burn-rate alerting
    (``repro_torch.obs.alerts``).

The attribution feeds back into planning: ``replan_priority()`` scores
watched (graph_fp, topo_fp) keys so the ``RecalibrationLoop`` replans
the worst-drifted workload first, and ``attributed_cause()`` is stamped
into the refreshed ``PlanRecord.meta["drift_cause"]`` — a replan now
records *why* (which stage, link, or sync) it happened.

Served by ``ObsServer`` as ``/runs``, ``/runs/<run_id>/health`` and
``/alerts``; exported as ``run_health_*`` gauges on every /metrics
scrape.
"""
from __future__ import annotations

from dataclasses import dataclass
import threading
import time

from repro_torch.obs.alerts import (
    DEFAULT_OBJECTIVE, AlertEvaluator, SLOTracker, default_rules)
from repro_torch.obs.trace import aggregate_events, executed_events_of

DEFAULT_RUN = "default"


def _run_id_of(rec) -> str:
    rid = rec.meta.get("run_id") if isinstance(rec.meta, dict) else None
    if rid:
        return str(rid)
    if rec.graph_fp or rec.topo_fp:
        return f"{rec.graph_fp[:12]}:{rec.topo_fp[:12]}"
    return DEFAULT_RUN


@dataclass
class _KeyStat:
    """Rolling residual state for one stage or one link of one run."""
    predicted_s: float = 0.0          # per-step busy seconds expected
    ewma_s: float = 0.0               # smoothed executed busy seconds
    n: int = 0
    hi_streak: int = 0
    lo_streak: int = 0
    straggling: bool = False
    since_step: int = -1

    def update(self, executed_s: float, alpha: float):
        self.n += 1
        self.ewma_s = executed_s if self.n == 1 else (
            alpha * executed_s + (1.0 - alpha) * self.ewma_s)
        if self.predicted_s <= 0:     # self-baselined: first step anchors
            self.predicted_s = executed_s

    @property
    def ratio(self) -> float:
        return self.ewma_s / self.predicted_s if self.predicted_s > 0 \
            else 1.0

    @property
    def residual_s(self) -> float:
        return self.ewma_s - self.predicted_s


class _Run:
    """Per-run rolling state (internal)."""

    def __init__(self, run_id: str):
        self.run_id = run_id
        self.graph_fp = ""
        self.topo_fp = ""
        self.registered = False        # watch() supplied predictions
        self.predicted_step_s = 0.0    # 0 until known / baselined
        self.sync_time = 0.0
        self.bubble_predicted: float | None = None
        self.pred_stage: dict = {}     # stage -> predicted busy s
        self.pred_link: dict = {}      # "src->dst" -> predicted busy s
        self.stages: dict = {}         # stage -> _KeyStat
        self.links: dict = {}          # "src->dst" -> _KeyStat
        self.steps = 0
        self.last_step = -1
        self.last_ts = 0.0
        self.step_ewma = 0.0
        self.bubble_ewma: float | None = None
        self.tracker: SLOTracker | None = None
        self.evaluator: AlertEvaluator | None = None

    # ------------------------------------------------------- derived views
    def ratios(self) -> list:
        """[(kind, key, _KeyStat)] across stages + links."""
        out = [("stage", str(s), st) for s, st in self.stages.items()]
        out += [("link", k, st) for k, st in self.links.items()]
        return out

    def dominant(self) -> dict:
        """The dominant residual, attributed category-first: compute vs
        transfer vs sync/other totals decide WHICH subsystem is at
        fault (robust to a slowdown smearing across both directions of
        a link, or partially hiding in pipeline slack), then the worst
        key inside the winning category says WHERE."""
        resid_c = sum(st.residual_s for st in self.stages.values())
        resid_x = sum(st.residual_s for st in self.links.values())
        step_resid = self.step_ewma - self.predicted_step_s \
            if self.predicted_step_s > 0 else 0.0
        sync = step_resid - resid_c - resid_x
        cause, total, table = max(
            [("stage", resid_c, self.stages),
             ("link", resid_x, self.links)],
            key=lambda c: abs(c[1]))
        if not table or abs(sync) > abs(total):
            return {"cause": "sync", "key": "sync", "residual_s": sync}
        key, st = max(table.items(),
                      key=lambda kv: abs(kv[1].residual_s))
        return {"cause": cause, "key": str(key),
                "residual_s": st.residual_s}

    def step_ratio(self) -> float:
        return self.step_ewma / self.predicted_step_s \
            if self.predicted_step_s > 0 else 1.0


class RunHealthAnalyzer:
    """Incremental telemetry -> health joiner; see the module docstring.

    ``store`` is a telemetry dir / ``.jsonl`` path or a
    ``MeasurementStore``; the analyzer owns its OWN ``read_new`` cursor,
    so it can share a telemetry dir with a ``RecalibrationLoop`` without
    stealing its records (pass a path, not the loop's store instance).
    With ``store=None`` the analyzer is feed-only (``ingest(rec)``).
    """

    def __init__(self, store=None, *, registry=None,
                 slo_s: float | None = None,
                 slo_objective: float = DEFAULT_OBJECTIVE,
                 alert_rules=None, ewma_alpha: float = 0.35,
                 straggler_ratio: float = 1.3, hysteresis_up: int = 2,
                 hysteresis_down: int = 2, top_k: int = 5,
                 max_runs: int = 64):
        from repro_torch.runtime.telemetry import MeasurementStore
        if isinstance(store, str):
            store = MeasurementStore(store)
        self.store = store
        self.registry = registry
        self.slo_s = slo_s                   # default for unwatched runs
        self.slo_objective = float(slo_objective)
        self.alert_rules = list(alert_rules) if alert_rules is not None \
            else default_rules()
        self.ewma_alpha = float(ewma_alpha)
        self.straggler_ratio = float(straggler_ratio)
        self.hysteresis_up = max(int(hysteresis_up), 1)
        self.hysteresis_down = max(int(hysteresis_down), 1)
        self.top_k = int(top_k)
        self.max_runs = int(max_runs)
        self._runs: dict = {}                # run_id -> _Run
        self._by_key: dict = {}              # (gfp, tfp) -> set(run_id)
        self._lock = threading.RLock()
        self.records_total = 0
        self.events_total = 0
        self.ingest_seconds = 0.0

    # ------------------------------------------------------------ register
    def watch(self, run_id: str, *, timeline=None, sync_time: float = 0.0,
              graph_fp: str = "", topo_fp: str = "",
              slo_s: float | None = None,
              slo_objective: float | None = None) -> str:
        """Register a run's predicted schedule (and optionally its SLO).

        ``timeline`` is the plan's simulated ``exec.schedule.Timeline``;
        per-stage/per-link predicted busy seconds, the predicted step
        time (makespan + ``sync_time``) and the predicted bubble
        fraction are lifted from it. Without a timeline the run is
        tracked in self-baselined mode (ratios relative to its own
        first steps).
        """
        with self._lock:
            run = self._run(run_id)
            run.graph_fp = graph_fp or run.graph_fp
            run.topo_fp = topo_fp or run.topo_fp
            if run.graph_fp or run.topo_fp:
                self._by_key.setdefault(
                    (run.graph_fp, run.topo_fp), set()).add(run_id)
            if timeline is not None:
                run.registered = True
                run.sync_time = float(sync_time)
                run.predicted_step_s = timeline.makespan + run.sync_time
                run.bubble_predicted = timeline.bubble_fraction()
                run.pred_stage, run.pred_link = {}, {}
                for e in timeline.events:
                    if e.kind == "X":
                        key = f"{e.src}->{e.stage}"
                        run.pred_link[key] = \
                            run.pred_link.get(key, 0.0) + e.dur
                    else:
                        run.pred_stage[e.stage] = \
                            run.pred_stage.get(e.stage, 0.0) + e.dur
                for s, d in run.pred_stage.items():
                    run.stages.setdefault(s, _KeyStat()).predicted_s = d
                for k, d in run.pred_link.items():
                    run.links.setdefault(k, _KeyStat()).predicted_s = d
            target = slo_s if slo_s is not None else self.slo_s
            if target is not None and run.tracker is None:
                self._arm_slo(run, target, slo_objective)
            return run_id

    def _arm_slo(self, run: _Run, target: float,
                 objective: float | None = None):
        ev = AlertEvaluator(self.alert_rules)
        run.tracker = SLOTracker(
            target,
            objective=objective if objective is not None
            else self.slo_objective,
            horizon_s=ev.horizon_s)
        run.evaluator = ev

    def _run(self, run_id: str) -> _Run:
        run = self._runs.get(run_id)
        if run is None:
            run = self._runs[run_id] = _Run(run_id)
            self._evict_lru(keep=run_id)
        return run

    def _evict_lru(self, keep: str):
        while len(self._runs) > self.max_runs:
            victim = min((r for r in self._runs.values()
                          if r.run_id != keep),
                         key=lambda r: (r.registered, r.last_ts))
            self._drop(victim.run_id)

    def _drop(self, run_id: str):
        run = self._runs.pop(run_id, None)
        if run is None:
            return
        self._by_key.get((run.graph_fp, run.topo_fp), set()).discard(
            run_id)
        if self.registry is not None:       # drop stale labeled series
            for m in self.registry.metrics():
                if m.name.startswith(("run_health_", "alert_")) \
                        and hasattr(m, "remove"):
                    m.remove(run=run_id)

    # -------------------------------------------------------------- ingest
    def poll(self) -> int:
        """Drain newly appended records from the store; returns count."""
        if self.store is None:
            return 0
        n = 0
        for rec in self.store.read_new():
            self.ingest(rec)
            n += 1
        return n

    def ingest(self, rec) -> str:
        """Fold one ``StepRecord`` into its run's rolling state; returns
        the run id it was attributed to."""
        t_in = time.perf_counter()
        with self._lock:
            run_id = _run_id_of(rec)
            run = self._run(run_id)
            if rec.graph_fp and not run.graph_fp:
                run.graph_fp, run.topo_fp = rec.graph_fp, rec.topo_fp
                self._by_key.setdefault(
                    (run.graph_fp, run.topo_fp), set()).add(run_id)
            ts = rec.ts or time.time()
            run.steps += 1
            run.last_step = rec.step
            run.last_ts = ts
            run.step_ewma = rec.wall_time if run.steps == 1 else (
                self.ewma_alpha * rec.wall_time
                + (1.0 - self.ewma_alpha) * run.step_ewma)
            if run.predicted_step_s <= 0:    # self-baselined step anchor
                run.predicted_step_s = rec.wall_time

            stage_s, link_s, n_events = self._reduce(rec, run)
            self.events_total += max(n_events, 1)
            for s, dur in stage_s.items():
                run.stages.setdefault(s, _KeyStat()).update(
                    dur, self.ewma_alpha)
            for k, dur in link_s.items():
                run.links.setdefault(k, _KeyStat()).update(
                    dur, self.ewma_alpha)
            self._rank_stragglers(run)

            if run.tracker is None and self.slo_s is not None:
                self._arm_slo(run, self.slo_s)
            if run.tracker is not None:
                run.tracker.observe(ts, rec.wall_time)
                for st in run.evaluator.evaluate(run.tracker, ts):
                    if self.registry is not None:
                        self.registry.counter(
                            "alert_transitions_total",
                            "run-health alert state transitions").inc(
                            run=run_id, rule=st.rule.name, to=st.state)
            if self.registry is not None:
                self.registry.counter(
                    "run_health_records_total",
                    "telemetry records folded into run health").inc()
            self.records_total += 1
            self.ingest_seconds += time.perf_counter() - t_in
            return run_id

    def _reduce(self, rec, run: _Run) -> tuple:
        """Per-stage / per-link executed busy seconds for one record.

        Prefers the exact per-event stream (``meta["events"]``); falls
        back to the compute/collective samples (link keys are then the
        producer's device-group ``pair``, normalized ``"gi->gj"``).
        Also rolls the executed bubble fraction.
        """
        meta = rec.meta if isinstance(rec.meta, dict) else {}
        if "events" in meta:
            agg = aggregate_events(executed_events_of(rec))
            stage_s, link_s = agg["stage"], agg["link"]
            n_events = len(meta["events"])
            bubble = meta.get("bubble_frac")
            if bubble is None and stage_s:
                t0, t1 = agg["span"]
                span = max(t1 - t0, 0.0)
                denom = span * len(stage_s)
                bubble = 1.0 - sum(stage_s.values()) / denom \
                    if denom > 0 else None
        else:
            stage_s, link_s = {}, {}
            for c in rec.compute:
                s = c.get("stage")
                if s is not None:
                    stage_s[int(s)] = stage_s.get(int(s), 0.0) \
                        + float(c.get("time", 0.0))
            for c in rec.collectives:
                pair = c.get("pair")
                if pair is not None:
                    key = str(pair).replace("-", "->", 1)
                    link_s[key] = link_s.get(key, 0.0) \
                        + float(c.get("time", 0.0))
            n_events = len(rec.compute) + len(rec.collectives)
            bubble = meta.get("bubble_frac")
        if bubble is not None:
            run.bubble_ewma = float(bubble) if run.bubble_ewma is None \
                else (self.ewma_alpha * float(bubble)
                      + (1.0 - self.ewma_alpha) * run.bubble_ewma)
        return stage_s, link_s, n_events

    def _rank_stragglers(self, run: _Run):
        """Normalized-slowdown hysteresis pass over all keys of a run.

        Each key's ratio is divided by the run-wide median ratio, so a
        uniform slowdown (all keys 2x) is drift — the feedback loop's
        job — while a localized one stands out. A key must exceed
        ``straggler_ratio`` for ``hysteresis_up`` consecutive steps to
        be flagged, and fall below it for ``hysteresis_down`` steps to
        clear.
        """
        stats = [st for _, _, st in run.ratios() if st.n > 0]
        if not stats:
            return
        ratios = sorted(st.ratio for st in stats)
        med = ratios[len(ratios) // 2] if len(ratios) % 2 else (
            ratios[len(ratios) // 2 - 1] + ratios[len(ratios) // 2]) / 2
        med = med if med > 0 else 1.0
        for st in stats:
            if st.ratio / med > self.straggler_ratio:
                st.hi_streak += 1
                st.lo_streak = 0
                if not st.straggling \
                        and st.hi_streak >= self.hysteresis_up:
                    st.straggling = True
                    st.since_step = run.last_step
            else:
                st.lo_streak += 1
                st.hi_streak = 0
                if st.straggling \
                        and st.lo_streak >= self.hysteresis_down:
                    st.straggling = False
                    st.since_step = -1

    # ------------------------------------------------------------- queries
    def run_ids(self) -> list:
        with self._lock:
            return sorted(self._runs)

    def _normalized(self, run: _Run) -> dict:
        stats = [st for _, _, st in run.ratios() if st.n > 0]
        ratios = sorted(st.ratio for st in stats)
        if not ratios:
            return {}
        med = ratios[len(ratios) // 2] if len(ratios) % 2 else (
            ratios[len(ratios) // 2 - 1] + ratios[len(ratios) // 2]) / 2
        med = med if med > 0 else 1.0
        return {id(st): st.ratio / med for st in stats}

    def _stragglers(self, run: _Run) -> list:
        norm = self._normalized(run)
        out = [{"kind": kind, "key": key, "ratio": st.ratio,
                "normalized": norm.get(id(st), 1.0),
                "since_step": st.since_step}
               for kind, key, st in run.ratios() if st.straggling]
        out.sort(key=lambda d: -d["normalized"])
        return out[:self.top_k]

    def health(self, run_id: str) -> dict:
        """Full health snapshot for one run; raises KeyError unknown."""
        with self._lock:
            run = self._runs.get(run_id)
            if run is None:
                raise KeyError(f"unknown run {run_id!r} "
                               f"(known: {sorted(self._runs)})")
            norm = self._normalized(run)

            def key_dict(st: _KeyStat) -> dict:
                return {"predicted_s": st.predicted_s,
                        "executed_s": st.ewma_s, "ratio": st.ratio,
                        "normalized": norm.get(id(st), 1.0),
                        "straggling": st.straggling,
                        "since_step": st.since_step, "steps": st.n}

            resid_c = sum(st.residual_s for st in run.stages.values())
            resid_x = sum(st.residual_s for st in run.links.values())
            step_resid = run.step_ewma - run.predicted_step_s \
                if run.predicted_step_s > 0 else 0.0
            d = {
                "run_id": run.run_id, "graph_fp": run.graph_fp,
                "topo_fp": run.topo_fp,
                "mode": "predicted" if run.registered
                        else "self_baselined",
                "steps": run.steps, "last_step": run.last_step,
                "last_ts": run.last_ts,
                "predicted_step_s": run.predicted_step_s,
                "step_ewma_s": run.step_ewma,
                "step_ratio": run.step_ratio(),
                "bubble": {"predicted": run.bubble_predicted,
                           "executed": run.bubble_ewma},
                "stages": {str(s): key_dict(st)
                           for s, st in sorted(run.stages.items())},
                "links": {k: key_dict(st)
                          for k, st in sorted(run.links.items())},
                "attribution": {
                    "compute_s": resid_c, "transfer_s": resid_x,
                    "sync_other_s": step_resid - resid_c - resid_x},
                "dominant": run.dominant(),
                "stragglers": self._stragglers(run),
            }
            if run.tracker is not None:
                windows = sorted({w for r in run.evaluator.rules
                                  for w in (r.short_window_s,
                                            r.long_window_s)})
                d["slo"] = run.tracker.to_dict(now=run.last_ts,
                                               windows=windows)
                d["alerts"] = [st.to_dict()
                               for st in run.evaluator.states()]
            else:
                d["slo"] = None
                d["alerts"] = []
            return d

    def run_summaries(self) -> list:
        """Compact per-run rows for the /runs index."""
        out = []
        with self._lock:
            ids = sorted(self._runs)
        for rid in ids:
            try:
                h = self.health(rid)
            except KeyError:
                continue
            out.append({
                "run_id": rid, "mode": h["mode"], "steps": h["steps"],
                "last_ts": h["last_ts"], "step_ratio": h["step_ratio"],
                "dominant": h["dominant"],
                "stragglers": len(h["stragglers"]),
                "alerts_firing": sum(1 for a in h["alerts"]
                                     if a["state"] == "firing")})
        return out

    def alerts(self) -> list:
        """All runs' alert states, firing first, pages before warns."""
        out = []
        with self._lock:
            for rid, run in sorted(self._runs.items()):
                if run.evaluator is None:
                    continue
                for st in run.evaluator.states():
                    out.append(dict(st.to_dict(), run_id=rid))
        out.sort(key=lambda a: (a["state"] != "firing",
                                a["severity"] != "page", a["rule"]))
        return out

    # ------------------------------------------------------- replan wiring
    def replan_priority(self) -> dict:
        """{(graph_fp, topo_fp): score} — how hard each key's worst run
        deviates from its predicted step (0 = on plan). The
        ``RecalibrationLoop`` drains drifted keys in descending order."""
        scores: dict = {}
        with self._lock:
            for key, rids in self._by_key.items():
                best = 0.0
                for rid in rids:
                    run = self._runs.get(rid)
                    if run is not None:
                        best = max(best, abs(run.step_ratio() - 1.0))
                if key[0] or key[1]:
                    scores[key] = best
        return scores

    def attributed_cause(self, graph_fp: str, topo_fp: str) -> dict | None:
        """The dominant residual for the worst run under a plan key —
        stamped into ``PlanRecord.meta["drift_cause"]`` on replan."""
        with self._lock:
            rids = self._by_key.get((graph_fp, topo_fp), ())
            runs = [self._runs[r] for r in rids if r in self._runs]
            if not runs:
                return None
            run = max(runs, key=lambda r: abs(r.step_ratio() - 1.0))
            return dict(run.dominant(), run_id=run.run_id,
                        step_ratio=run.step_ratio(), ts=run.last_ts)

    # ------------------------------------------------------------- metrics
    def export_metrics(self, registry=None):
        """Refresh the ``run_health_*`` gauge families (called by the
        served plane on every /metrics scrape)."""
        reg = registry if registry is not None else self.registry
        if reg is None:
            return
        g = reg.gauge
        with self._lock:
            g("run_health_runs", "runs tracked by the health analyzer"
              ).set(len(self._runs))
            for rid, run in self._runs.items():
                g("run_health_step_ratio",
                  "EWMA executed / predicted step time").set(
                    run.step_ratio(), run=rid)
                if run.bubble_ewma is not None:
                    g("run_health_bubble",
                      "pipeline bubble fraction by origin").set(
                        run.bubble_ewma, run=rid, origin="executed")
                if run.bubble_predicted is not None:
                    g("run_health_bubble",
                      "pipeline bubble fraction by origin").set(
                        run.bubble_predicted, run=rid, origin="predicted")
                for s, st in run.stages.items():
                    g("run_health_stage_ratio",
                      "per-stage executed/predicted compute ratio").set(
                        st.ratio, run=rid, stage=str(s))
                for k, st in run.links.items():
                    g("run_health_link_ratio",
                      "per-link executed/predicted transfer ratio").set(
                        st.ratio, run=rid, link=k)
                g("run_health_stragglers",
                  "keys currently flagged as stragglers").set(
                    sum(1 for _, _, st in run.ratios()
                        if st.straggling), run=rid)
                if run.tracker is not None:
                    for rule in run.evaluator.rules:
                        for w in {rule.short_window_s,
                                  rule.long_window_s}:
                            g("run_health_slo_burn",
                              "SLO error-budget burn rate by window").set(
                                run.tracker.burn_rate(w, run.last_ts),
                                run=rid, window=str(int(w)))
                    for st in run.evaluator.states():
                        g("run_health_alert_firing",
                          "1 while a run-health alert fires").set(
                            1.0 if st.firing else 0.0, run=rid,
                            rule=st.rule.name,
                            severity=st.rule.severity)

    def stats(self) -> dict:
        with self._lock:
            per_event = (self.ingest_seconds / self.events_total
                         if self.events_total else 0.0)
            return {"runs": len(self._runs),
                    "records": self.records_total,
                    "events": self.events_total,
                    "ingest_us_per_event": per_event * 1e6,
                    "slo_s": self.slo_s,
                    "rules": [r.to_dict() for r in self.alert_rules]}
