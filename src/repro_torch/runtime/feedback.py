"""FeedbackLoop: the paper's §4.3 closed loop over the planner service.

    loop = FeedbackLoop(service)
    result = loop.observe(gg, topo, step_record)

Each observation is appended to the measurement log and compared — via an
EWMA drift detector — against the cached plan's simulated makespan. Past
the drift threshold the loop:

  1. fits a ``CalibrationProfile`` from this topology's accumulated
     telemetry (falling back to the triggering record alone),
  2. invalidates the stale ``PlanStore`` entry,
  3. re-searches warm-started from the stale strategy, on the CALIBRATED
     topology, with the observed runtime features routed into the GNN,
  4. stores and returns the refreshed plan.

The replacement plan's simulated time *under the calibrated cost model*
is compared against the stale plan re-simulated under the same model, so
``result.improved`` states whether replanning actually helped.
"""
from __future__ import annotations

from dataclasses import dataclass
import threading
import time

from repro_torch.core import tag as tag_mod
from repro_torch.core.device import Topology
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.strategy import canonical_strategies
from repro_torch.runtime.calibration import (
    CalibrationProfile, fit_profile, uniform_profile)
from repro_torch.runtime.drift import DriftDetector, DriftReport
from repro_torch.runtime.telemetry import (
    MeasurementStore, StepRecord, observed_sim_result)


@dataclass
class FeedbackResult:
    kind: str                              # no_plan | ok | replanned
    report: DriftReport | None = None
    profile: CalibrationProfile | None = None
    response: object = None                # PlanResponse of the new plan
    stale_time: float | None = None        # stale plan under calib model
    observed: float | None = None

    @property
    def improved(self) -> bool:
        return (self.kind == "replanned" and self.response is not None
                and self.stale_time is not None
                and self.response.time <= self.stale_time * (1 + 1e-9))


class FeedbackLoop:
    def __init__(self, service, *,
                 measurements: MeasurementStore | None = None,
                 drift_threshold: float = 0.25, ewma_alpha: float = 0.5,
                 min_samples: int = 1, max_history: int = 256):
        self.service = service
        self.measurements = measurements if measurements is not None \
            else MeasurementStore()
        self.detector = DriftDetector(threshold=drift_threshold,
                                      alpha=ewma_alpha,
                                      min_samples=min_samples)
        # calibration window: newest records consulted on a drift event —
        # bounds the refit cost on long-lived logs and keeps the profile
        # tracking the CURRENT cluster, not its whole history
        self.max_history = max_history

    def observe(self, gg: GroupedGraph, topo: Topology, observation,
                *, iterations: int = 20, seed: int = 0,
                enable_sfb: bool = True,
                append: bool = True) -> FeedbackResult:
        """Feed one observed step back into the planner.

        ``observation`` is a ``StepRecord`` (preferred — its samples feed
        calibration) or a bare observed step time in seconds.

        ``append=False`` skips writing the record to the measurement
        store — for callers (the ``RecalibrationLoop`` poller) whose
        observation was *read from* that same store and must not be
        duplicated back into it.
        """
        from repro_torch.service.fingerprint import (
            fingerprint_grouped, fingerprint_topology)
        from repro_torch.service.warmstart import adapt_strategy

        graph_fp = fingerprint_grouped(gg)
        topo_fp = fingerprint_topology(topo)
        if isinstance(observation, StepRecord):
            rec = observation
            rec.graph_fp, rec.topo_fp = graph_fp, topo_fp
        else:
            rec = StepRecord(graph_fp=graph_fp, topo_fp=topo_fp,
                             wall_time=float(observation))
        if append:
            self.measurements.append(rec)

        cached = self.service.store.get(graph_fp, topo_fp)
        if cached is None:
            return FeedbackResult(kind="no_plan", observed=rec.wall_time)

        report = self.detector.update(graph_fp, topo_fp, cached.time,
                                      rec.wall_time)
        if not report.drifted:
            return FeedbackResult(kind="ok", report=report,
                                  observed=rec.wall_time)

        # ---- drift: recalibrate, invalidate, warm re-search
        history = self.measurements.records(
            graph_fp=graph_fp, topo_fp=topo_fp,
            limit=self.max_history) or [rec]
        profile = fit_profile(history, topo)
        if not profile.util and not profile.links:
            # wall-time-only telemetry (e.g. the CLI's --observed-time):
            # fall back to a uniform slowdown matching the smoothed
            # observation
            profile = uniform_profile(topo, cached.time / report.ewma
                                      if report.ewma > 0 else 1.0,
                                      n_records=len(history))
        calib_topo = profile.apply(topo)

        stale_strat = cached.strategy_obj()
        # schedule-aware when the stale plan pipelines, FIFO otherwise —
        # the SAME model the planner reported cached.time under, so the
        # improved/regressed verdict compares like with like
        stale_time = tag_mod.strategy_step_time(
            gg, stale_strat, calib_topo, sfb=enable_sfb)

        self.service.store.evict(graph_fp=graph_fp, topo_fp=topo_fp)
        self.detector.reset(graph_fp, topo_fp)

        # Seed the re-search from the best of {stale plan, canonical
        # families} re-scored under the CALIBRATED model: a drifted
        # cluster (e.g. congested cross-machine fabric) can move the
        # optimum far from the cached plan, and MCTS warm-started from a
        # now-bad prior would stay in its basin.
        seed_strat, seed_time = adapt_strategy(stale_strat, gg.n,
                                               calib_topo), stale_time
        for cand in canonical_strategies(gg.n, calib_topo):
            t = tag_mod.strategy_step_time(gg, cand, calib_topo,
                                           sfb=enable_sfb)
            if t < seed_time:
                seed_strat, seed_time = cand, t

        # The refreshed plan is searched under the CALIBRATED topology but
        # stored under the NOMINAL (deployment) key: that is the key the
        # next launch plans with and the next observation joins against —
        # keying by the calibrated fingerprint would orphan the entry and
        # make every later observe() report "no_plan".
        resp = self.service.plan_graph(
            gg, calib_topo, iterations=iterations, seed=seed,
            enable_sfb=enable_sfb, prior_strategy=seed_strat,
            fingerprints=(graph_fp, topo_fp),
            observed_feedback=observed_sim_result(history, topo))
        return FeedbackResult(
            kind="replanned", report=report, profile=profile,
            response=resp, stale_time=stale_time,
            observed=rec.wall_time)


class RecalibrationLoop:
    """Continuous, unattended plan -> execute -> observe -> replan.

    A background thread polls the service's ``MeasurementStore`` via
    ``read_new()`` (the incremental, complete-lines-only cursor), so any
    process appending ``StepRecord``s to the shared telemetry dir —
    ``launch.train --telemetry-dir``, the replay executor, the real
    engine — feeds the drift detector with no manual ``observe`` call.

    Records only carry fingerprints; replanning needs the (graph,
    topology) objects, so workloads are registered with ``watch(gg,
    topo)``. Records for unwatched fingerprints are counted
    (``recalib_records_total{outcome="unwatched"}``) and skipped. Every
    processed record goes through ``service.observe(..., append=False)``
    — ``append=False`` because the record was *read from* the same store
    observe would write it back to. After each batch the calibration
    profile is refit from the watched workload's accumulated telemetry
    and published as gauges (``profile_metrics``), so /metrics always
    shows the currently-fitted cluster state.

    Backlog control is two-tier: the whole poll is capped at
    ``max_batch`` records (oldest dropped,
    ``recalib_records_total{outcome="dropped"}``), then each watched
    key keeps only its newest ``max_per_key`` records — older
    duplicates of the same workload only re-smooth the same EWMA, so
    shedding them (``recalib_backlog_shed_total``) bounds a flooded
    telemetry dir's poll cost without losing any key's newest signal.
    ``recalib_backlog_depth`` gauges the pre-shed backlog per poll.

    ``health`` (a ``repro_torch.obs.health.RunHealthAnalyzer``) upgrades the
    loop from arrival-order to severity-order: watched keys drain in
    descending ``replan_priority()`` score, so when several workloads
    drift at once the worst-deviating one replans FIRST, and each
    replanned verdict is stamped with the analyzer's attributed cause
    (``DriftReport.cause`` + ``PlanRecord.meta["drift_cause"]``).
    """

    def __init__(self, service, *, interval_s: float = 5.0,
                 iterations: int = 20, seed: int = 0,
                 enable_sfb: bool = True, max_batch: int = 256,
                 max_per_key: int = 32, health=None):
        self.service = service
        self.interval_s = float(interval_s)
        self.iterations = int(iterations)
        self.seed = int(seed)
        self.enable_sfb = bool(enable_sfb)
        self.max_batch = int(max_batch)
        self.max_per_key = max(int(max_per_key), 1)
        self.health = health
        self._watched: dict = {}            # (graph_fp, topo_fp) -> (gg, t)
        self._last_order: list = []         # key drain order of last poll
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()       # one poll at a time
        reg = service.metrics
        self._m_polls = reg.counter(
            "recalib_polls_total", "recalibration store polls")
        self._m_records = reg.counter(
            "recalib_records_total",
            "telemetry records consumed by the recalibration loop, "
            "by outcome")
        self._m_last = reg.gauge(
            "recalib_last_poll_unixtime", "wall time of the latest poll")
        self._m_running = reg.gauge(
            "recalib_running", "1 while the recalibration thread runs")
        self._m_watched = reg.gauge(
            "recalib_watched_workloads",
            "(graph, topology) pairs registered for replanning")
        self._m_backlog = reg.gauge(
            "recalib_backlog_depth",
            "records found waiting at the start of the latest poll")
        self._m_shed = reg.counter(
            "recalib_backlog_shed_total",
            "stale per-key records shed before processing (oldest "
            "first; each key keeps its newest max_per_key)")

    # ------------------------------------------------------------- control
    def watch(self, gg, topo) -> tuple:
        """Register a workload; returns its (graph_fp, topo_fp) key."""
        from repro_torch.service.fingerprint import (
            fingerprint_grouped, fingerprint_topology)
        key = (fingerprint_grouped(gg), fingerprint_topology(topo))
        self._watched[key] = (gg, topo)
        self._m_watched.set(len(self._watched))
        return key

    def start(self) -> "RecalibrationLoop":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="recalibration", daemon=True)
        self._thread.start()
        self._m_running.set(1)
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._m_running.set(0)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:               # a bad poll must not kill the
                self._m_records.inc(outcome="error")      # daemon thread
        self._m_running.set(0)

    # ------------------------------------------------------------ polling
    def poll_once(self) -> list:
        """Drain newly appended records once; returns the
        ``FeedbackResult``s of processed (watched) records, in the
        order they were processed (priority order when a health
        analyzer is attached)."""
        with self._lock:
            store = self.service.measurements
            recs = store.read_new()
            self._m_polls.inc()
            self._m_last.set(time.time())
            self._m_backlog.set(len(recs))
            results = []
            touched: set = set()
            if len(recs) > self.max_batch:   # never replay an unbounded
                self._m_records.inc(len(recs) - self.max_batch,
                                    outcome="dropped")    # backlog silently
                recs = recs[-self.max_batch:]
            if self.health is not None:
                # keep the analyzer's view fresh BEFORE ordering keys.
                # An analyzer with its own store cursor drains it; a
                # feed-only analyzer rides this poll's records.
                if getattr(self.health, "store", None) is not None:
                    self.health.poll()
                else:
                    for rec in recs:
                        try:
                            self.health.ingest(rec)
                        except Exception:
                            pass             # health is advisory, never
                                             # blocks recalibration
            by_key: dict = {}               # key -> records, oldest first
            for rec in recs:
                key = (rec.graph_fp, rec.topo_fp)
                if key not in self._watched:
                    self._m_records.inc(outcome="unwatched")
                    continue
                by_key.setdefault(key, []).append(rec)
            # per-key shedding: EWMA smoothing means only the newest
            # records of a flooded key carry signal — keep those
            for key, krecs in by_key.items():
                if len(krecs) > self.max_per_key:
                    shed = len(krecs) - self.max_per_key
                    self._m_shed.inc(shed)
                    self._m_records.inc(shed, outcome="shed")
                    by_key[key] = krecs[-self.max_per_key:]
            order = sorted(by_key, key=self._priority, reverse=True)
            self._last_order = list(order)
            for key in order:
                gg, topo = self._watched[key]
                for rec in by_key[key]:
                    try:
                        res = self.service.observe(
                            gg, topo, rec, iterations=self.iterations,
                            seed=self.seed, enable_sfb=self.enable_sfb,
                            append=False)
                    except Exception:
                        self._m_records.inc(outcome="error")
                        continue
                    self._m_records.inc(outcome=res.kind)
                    touched.add(key)
                    if res.kind == "replanned":
                        self._annotate_cause(key, res)
                    results.append(res)
            for key in touched:
                self._publish_calibration(key, store)
            return results

    def _priority(self, key: tuple) -> tuple:
        """Drain order for a watched key: health-attributed deviation
        first (worst drift replans before any un-drifted workload),
        fingerprints as a deterministic tiebreak."""
        score = 0.0
        if self.health is not None:
            try:
                score = self.health.replan_priority().get(key, 0.0)
            except Exception:
                score = 0.0
        return (score, key[0], key[1])

    def _annotate_cause(self, key: tuple, res):
        """Stamp the analyzer's attributed cause onto a replanned
        verdict: the DriftReport carries it back to the caller and the
        refreshed PlanRecord persists it in ``meta["drift_cause"]``."""
        if self.health is None:
            return
        try:
            cause = self.health.attributed_cause(*key)
        except Exception:
            return
        if not cause:
            return
        if res.report is not None:
            res.report.cause = cause
        rec = self.service.store.get(*key)
        if rec is not None:
            rec.meta["drift_cause"] = cause
            self.service.store.put(rec)

    def _publish_calibration(self, key: tuple, store: MeasurementStore):
        """Refit + publish calibration gauges for one watched workload."""
        _, topo = self._watched[key]
        history = store.records(graph_fp=key[0], topo_fp=key[1], limit=256)
        if not history:
            return
        from repro_torch.runtime.calibration import profile_metrics
        profile = fit_profile(history, topo)
        if not profile.util and not profile.links:
            profile = uniform_profile(topo, 1.0, n_records=len(history))
        profile_metrics(profile, self.service.metrics)

    def stats(self) -> dict:
        return {"running": self.running,
                "interval_s": self.interval_s,
                "watched": len(self._watched),
                "polls": self._m_polls.value(),
                "records": {
                    k: self._m_records.value(outcome=k)
                    for k in ("ok", "replanned", "no_plan", "unwatched",
                              "error", "shed", "dropped")},
                "backlog_depth": self._m_backlog.value(),
                "shed_total": self._m_shed.value(),
                "last_order": [[k[0][:12], k[1][:12]]
                               for k in self._last_order],
                "last_poll_unixtime": self._m_last.value()}
