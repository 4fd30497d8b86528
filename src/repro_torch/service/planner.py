"""PlannerService: the traffic-facing front end of the TAG pipeline.

    svc = PlannerService(cache_dir=".plans")
    resp = svc.plan(loss_fn, params, batch, topo)       # traces + searches
    resp = svc.plan_graph(gg, topo, iterations=60)      # pre-grouped graph

Responses record their provenance: "hit" (served from the store, zero
MCTS playouts, byte-identical strategy), "warm" (search seeded from a
near-hit donor), or "cold" (full search). ``plan_many`` batches requests
with per-request budgets and within-batch dedup.
"""
from __future__ import annotations

from dataclasses import dataclass
import os
import time

from repro_torch.core import tag as tag_mod
from repro_torch.core.device import Topology
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.strategy import Strategy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import get_tracer
from repro_torch.service.fingerprint import (
    fingerprint_grouped_cached, fingerprint_topology,
    structural_features_cached, topology_structure_fingerprint)
from repro_torch.service.registry import PolicyRegistry
from repro_torch.service.store import PlanRecord, PlanStore
from repro_torch.service.warmstart import adapt_strategy, find_prior
from repro_torch.verify import PlanVerificationError, verify_deployment

POLICY_SUBDIR = "policies"

VERIFY_MODES = ("off", "warn", "reject")


@dataclass
class PlanRequest:
    """One planning request with its own search budget."""
    gg: GroupedGraph
    topo: Topology
    iterations: int = 60
    seed: int = 0
    enable_sfb: bool = True
    stop_reward: float | None = None


@dataclass
class PlanResponse:
    strategy: Strategy
    sfb_plans: dict                  # {gid: GroupSFB}
    time: float                      # simulated per-iteration seconds
    baseline_time: float
    source: str                      # "hit" | "warm" | "cold"
    iterations_run: int              # MCTS playouts spent on this request
    graph_fp: str
    topo_fp: str
    best_reward: float = 0.0         # MCTS-level reward (pre-SFB speedup);
                                     # stop_reward targets compare to this
    policy: str | None = None        # registry checkpoint that guided the
                                     # search (None: unguided / cache hit)
    verify: dict | None = None       # static-verifier verdict summary
                                     # (repro_torch.verify Report.summary());
                                     # None when verification is off

    @property
    def speedup(self):
        return self.baseline_time / self.time if self.time > 0 else 0.0


class PlannerService:
    def __init__(self, *, store: PlanStore | None = None,
                 cache_dir: str | None = None, capacity: int = 256,
                 policy=None, warm_start: bool = True,
                 prior_weight: float = 0.6,
                 registry: PolicyRegistry | None = None,
                 policy_dir: str | None = None,
                 use_registry: bool = True,
                 measurements=None, drift_threshold: float = 0.25,
                 drift_min_samples: int = 1,
                 drift_ewma_alpha: float = 0.5,
                 telemetry_dir: str | None = None,
                 verify: str = "warn", device=None):
        self.store = store if store is not None \
            else PlanStore(capacity=capacity, path=cache_dir)
        self.policy = policy
        # trained-prior source (paper §5.2): an explicit ``policy``
        # callable wins; otherwise the registry living next to the plan
        # store (``<cache_dir>/policies``, or ``policy_dir``) supplies the
        # best-matching trained checkpoint per request. An empty/missing
        # registry degrades to unguided search. Its policies run on
        # ``device`` (cuda unless asked otherwise).
        if registry is None and use_registry:
            rdir = policy_dir or (os.path.join(cache_dir, POLICY_SUBDIR)
                                  if cache_dir else None)
            registry = PolicyRegistry(rdir, device=device) if rdir else None
        self.registry = registry if use_registry else None
        self.warm_start = warm_start
        self.prior_weight = prior_weight
        # static plan verification (repro_torch.verify) of every fresh search
        # result: "off" skips it, "warn" annotates the response and
        # refuses to cache error-carrying plans, "reject" additionally
        # raises PlanVerificationError instead of returning them
        if verify not in VERIFY_MODES:
            raise ValueError(f"verify={verify!r} (use one of "
                             f"{VERIFY_MODES})")
        self.verify_mode = verify
        self._stats = {"requests": 0, "hits": 0, "warm": 0, "cold": 0,
                       "batch_dedup": 0, "iterations": 0,
                       "policy_guided": 0,
                       "observations": 0, "replans": 0,
                       "verify_clean": 0, "verify_warn": 0,
                       "verify_error": 0}
        # structured metrics mirror of _stats (+ latency/playout
        # distributions), dumped by ``python -m repro_torch.service.cli metrics`` and merged
        # into ``stats()``
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "planner_requests_total", "plan requests by provenance")
        self._m_latency = self.metrics.histogram(
            "planner_plan_seconds", "plan_graph wall seconds by provenance")
        self._m_playouts = self.metrics.histogram(
            "planner_playouts", "MCTS playouts spent per request",
            buckets=[0, 5, 10, 20, 40, 80, 160, 320, 640])
        self._m_playouts_to_best = self.metrics.histogram(
            "planner_playouts_to_best",
            "playouts until the search first beat the DP baseline",
            buckets=[0, 5, 10, 20, 40, 80, 160, 320, 640])
        self._m_store = self.metrics.gauge(
            "planner_store_size", "plans resident in the store")
        self._m_verify = self.metrics.counter(
            "planner_verify_total",
            "static plan verifications by verdict")
        self._m_verify_rejected = self.metrics.counter(
            "planner_verify_rejected_total",
            "plans refused store entry over error diagnostics")
        self._m_verify_seconds = self.metrics.histogram(
            "planner_verify_seconds",
            "static verification wall seconds",
            buckets=[0.001, 0.005, 0.02, 0.1, 0.5, 2.0])
        self._m_observe = self.metrics.counter(
            "planner_observations_total",
            "feedback observations by outcome")
        self._m_drift = self.metrics.gauge(
            "planner_drift_ratio",
            "latest observed |ewma - simulated| / simulated")
        # runtime feedback loop (repro_torch.runtime): created lazily so the
        # service stays import-light when feedback is unused
        self._drift_threshold = drift_threshold
        self._drift_min_samples = drift_min_samples
        self._drift_ewma_alpha = drift_ewma_alpha
        self._measurements = measurements
        self._telemetry_dir = telemetry_dir
        self._feedback = None

    # ----------------------------------------------------------------- API
    def plan(self, loss_fn, params, batch, topo: Topology, *,
             name: str = "", n_groups: int = 60, **kw) -> PlanResponse:
        """Trace a training function and plan its deployment."""
        gg = tag_mod.build_grouped(loss_fn, params, batch, name, n_groups)
        return self.plan_graph(gg, topo, **kw)

    def plan_graph(self, gg: GroupedGraph, topo: Topology, *,
                   iterations: int = 60, seed: int = 0,
                   enable_sfb: bool = True,
                   stop_reward: float | None = None,
                   fingerprints: tuple | None = None,
                   prior_strategy=None,
                   observed_feedback=None) -> PlanResponse:
        """Plan a grouped graph's deployment on a topology.

        ``prior_strategy`` forces a warm start from the given strategy
        (the feedback loop seeds re-searches from the invalidated plan
        this way); ``observed_feedback`` is a SimResult-shaped aggregate
        of measured telemetry routed into the GNN features in place of
        the simulated runtime feedback.
        """
        t_plan = time.perf_counter()
        tracer = get_tracer()
        with tracer.span("plan", cat="planner", iterations=iterations):
            with tracer.span("fingerprint", cat="planner"):
                graph_fp, topo_fp = fingerprints or (
                    fingerprint_grouped_cached(gg),
                    fingerprint_topology(topo))
                struct_fp = topology_structure_fingerprint(topo)
                graph_feat = structural_features_cached(gg)
            self._stats["requests"] += 1

            with tracer.span("store_lookup", cat="planner"):
                if prior_strategy is not None:
                    kind, rec = "forced", None
                elif self.warm_start:
                    kind, rec = find_prior(self.store, graph_fp, topo_fp,
                                           struct_fp,
                                           graph_features=graph_feat)
                else:
                    rec = self.store.get(graph_fp, topo_fp)
                    kind = "hit" if rec is not None else "miss"
            if kind == "hit" and not (
                    rec.meta.get("enable_sfb", True) == enable_sfb
                    and rec.meta.get("iterations", 0) >= iterations):
                # cached under a smaller budget or different SFB setting:
                # don't let it shadow the request — re-search, seeded
                # from it
                kind = "stale_hit"
            if kind == "hit":
                self._stats["hits"] += 1
                self._finish_metrics("hit", t_plan, playouts=0)
                return PlanResponse(
                    strategy=rec.strategy_obj(), sfb_plans=rec.sfb_objs(),
                    time=rec.time, baseline_time=rec.baseline_time,
                    source="hit", iterations_run=0,
                    graph_fp=graph_fp, topo_fp=topo_fp,
                    best_reward=float(rec.meta.get("best_reward", 0.0)),
                    verify=rec.meta.get("verify"))

            prior = None
            if kind == "forced":
                prior = prior_strategy
                self._stats["warm"] += 1
            elif kind in ("warm_topo", "warm_graph", "warm_struct",
                          "stale_hit"):
                prior = adapt_strategy(rec.strategy_obj(), gg.n, topo)
                self._stats["warm"] += 1
            else:
                self._stats["cold"] += 1

            with tracer.span("policy_resolve", cat="planner"):
                policy_name, policy = self._resolve_policy(graph_fp,
                                                           graph_feat)
            with tracer.span("search", cat="planner",
                             iterations=iterations):
                res = tag_mod.optimize(
                    None, None, None, topo, gg=gg, policy=policy,
                    iterations=iterations, seed=seed,
                    enable_sfb=enable_sfb,
                    prior_strategy=prior, prior_weight=self.prior_weight,
                    stop_reward=stop_reward,
                    observed_feedback=observed_feedback)
            self._stats["iterations"] += res.search.iterations_run

            verify_summary = None
            verify_diagnostics = None
            verify_ok = True
            if self.verify_mode != "off":
                t_verify = time.perf_counter()
                with tracer.span("verify", cat="planner"):
                    report = verify_deployment(gg, res.strategy, topo)
                self._m_verify_seconds.observe(
                    time.perf_counter() - t_verify)
                verify_summary = report.summary()
                # the full TAGxxx diagnostic list rides along in the
                # cached record so the served plane (/plans,
                # /plans/<fp>/verify) can show WHAT was flagged, not
                # just how many
                verify_diagnostics = report.to_dict()["diagnostics"]
                verify_ok = report.ok
                self._m_verify.inc(verdict=report.verdict)
                self._stats["verify_" + report.verdict] += 1
                if not verify_ok:
                    # an error-carrying plan is never cached: a bad plan
                    # served from the store would be a fleet incident,
                    # not a local traceback
                    self._m_verify_rejected.inc()
                    if self.verify_mode == "reject":
                        raise PlanVerificationError(
                            report, context=f"graph {graph_fp[:12]} on "
                                            f"topo {topo_fp[:12]}")
            if verify_ok:
                with tracer.span("store_put", cat="planner"):
                    self.store.put(PlanRecord(
                        graph_fp=graph_fp, topo_fp=topo_fp,
                        topo_struct_fp=struct_fp,
                        n_groups=gg.n, topo_m=topo.m,
                        strategy=res.strategy.to_dict(),
                        sfb_plans={str(g): p.to_dict()
                                   for g, p in res.sfb_plans.items()},
                        time=res.time, baseline_time=res.baseline_time,
                        graph_features=graph_feat,
                        meta={"iterations": iterations, "seed": seed,
                              "enable_sfb": enable_sfb,
                              "iterations_run": res.search.iterations_run,
                              "best_reward": res.search.best_reward,
                              "policy": policy_name,
                              "verify": verify_summary,
                              "verify_diagnostics": verify_diagnostics,
                              "source": "warm" if prior is not None
                              else "cold"}))
            source = "warm" if prior is not None else "cold"
            self._finish_metrics(
                source, t_plan, playouts=res.search.iterations_run,
                to_best=res.search.iters_to_beat_baseline)
            return PlanResponse(
                strategy=res.strategy, sfb_plans=res.sfb_plans,
                time=res.time, baseline_time=res.baseline_time,
                source=source,
                iterations_run=res.search.iterations_run,
                graph_fp=graph_fp, topo_fp=topo_fp,
                best_reward=res.search.best_reward,
                policy=policy_name, verify=verify_summary)

    def _finish_metrics(self, source: str, t_start: float, *,
                        playouts: int, to_best: int | None = None):
        self._m_requests.inc(source=source)
        self._m_latency.observe(time.perf_counter() - t_start,
                                source=source)
        self._m_playouts.observe(playouts, source=source)
        if to_best is not None and to_best >= 0:
            self._m_playouts_to_best.observe(to_best)
        self._m_store.set(len(self.store))

    def _resolve_policy(self, graph_fp: str, graph_feat):
        """Trained priors for a search: an explicit ``policy=`` callable
        wins (name None); otherwise the registry's best-matching
        checkpoint; otherwise unguided."""
        if self.policy is not None:
            return None, self.policy
        if self.registry is None:
            return None, None
        name, policy = self.registry.resolve(graph_fp=graph_fp,
                                             graph_features=graph_feat)
        if policy is not None:
            self._stats["policy_guided"] += 1
        return name, policy

    def plan_many(self, requests: list) -> list:
        """Plan a batch of PlanRequests. Identical (graph, topology) pairs
        inside the batch are planned once; repeats are store hits."""
        out = []
        seen: set = set()
        for req in requests:
            key = (fingerprint_grouped_cached(req.gg),
                   fingerprint_topology(req.topo))
            if key in seen:
                self._stats["batch_dedup"] += 1
            seen.add(key)
            out.append(self.plan_graph(
                req.gg, req.topo, iterations=req.iterations, seed=req.seed,
                enable_sfb=req.enable_sfb, stop_reward=req.stop_reward,
                fingerprints=key))
        return out

    # ------------------------------------------------- runtime feedback
    def feedback_loop(self):
        """The lazily-created runtime FeedbackLoop bound to this service
        (drift detection, cost-model calibration, replanning)."""
        if self._feedback is None:
            from repro_torch.runtime.feedback import FeedbackLoop
            from repro_torch.runtime.telemetry import MeasurementStore
            meas = self._measurements
            if meas is None:
                meas = MeasurementStore(self._telemetry_dir)
            self._feedback = FeedbackLoop(
                self, measurements=meas,
                drift_threshold=self._drift_threshold,
                ewma_alpha=self._drift_ewma_alpha,
                min_samples=self._drift_min_samples)
        return self._feedback

    @property
    def measurements(self):
        return self.feedback_loop().measurements

    def observe(self, gg: GroupedGraph, topo: Topology, observation, *,
                iterations: int = 20, seed: int = 0,
                enable_sfb: bool = True, append: bool = True):
        """Feed an observed step (a ``repro_torch.runtime.telemetry.StepRecord``
        or a bare step time in seconds) back into the planner: below the
        drift threshold this only logs telemetry; past it, the cached plan
        is invalidated and re-searched warm under a recalibrated cost
        model. Returns a ``repro_torch.runtime.feedback.FeedbackResult``.

        ``append=False`` when the observation was itself read from this
        service's measurement store (the recalibration poller), so it is
        not written back as a duplicate."""
        with get_tracer().span("observe", cat="planner"):
            res = self.feedback_loop().observe(
                gg, topo, observation, iterations=iterations, seed=seed,
                enable_sfb=enable_sfb, append=append)
        self._stats["observations"] += 1
        if res.kind == "replanned":
            self._stats["replans"] += 1
        self._m_observe.inc(outcome=res.kind)
        if res.report is not None:
            self._m_drift.set(res.report.drift,
                              graph=res.report.graph_fp[:8],
                              topo=res.report.topo_fp[:8])
        return res

    def stats(self) -> dict:
        s = dict(self._stats)
        s["store_size"] = len(self.store)
        s["hit_rate"] = s["hits"] / s["requests"] if s["requests"] else 0.0
        s["metrics"] = self.metrics.to_dict()
        return s

    def plan_entries(self) -> list:
        """Per-plan rows for the served plane: fingerprints, timings,
        the cached verify verdict summary AND the full TAGxxx
        diagnostic list, plus the attributed drift cause when the
        recalibration path has replanned the entry."""
        out = []
        for rec in self.store.records():
            out.append({
                "graph_fp": rec.graph_fp, "topo_fp": rec.topo_fp,
                "n_groups": rec.n_groups, "topo_m": rec.topo_m,
                "time_s": rec.time, "baseline_time_s": rec.baseline_time,
                "speedup": rec.speedup,
                "source": rec.meta.get("source"),
                "policy": rec.meta.get("policy"),
                "verify": rec.meta.get("verify"),
                "verify_diagnostics":
                    rec.meta.get("verify_diagnostics"),
                "drift_cause": rec.meta.get("drift_cause"),
            })
        out.sort(key=lambda e: (e["graph_fp"], e["topo_fp"]))
        return out

    # ------------------------------------------------- served observability
    def serve_metrics(self, *, host: str = "127.0.0.1", port: int = 0,
                      spool_dir: str | None = None,
                      run_id: str = "planner", recalibrate: bool = True,
                      interval_s: float = 5.0, iterations: int = 20,
                      spool_max_age_s: float | None = None,
                      spool_max_bytes: int | None = None,
                      slo_s: float | None = None,
                      alert_rules=None, health: bool = True,
                      start: bool = True):
        """Embed the live observability plane in this service.

        Returns a started ``repro_torch.obs.server.ObsServer`` exposing this
        service's registry on /metrics, per-plan verify diagnostics on
        /plans, run health on /runs + /alerts, and — when ``spool_dir``
        is given — the cross-process trace collector on
        /traces/<run_id>, with this process's planner spans drained into
        its own spool shard on every scrape. ``recalibrate=True`` also
        attaches a ``RecalibrationLoop`` (its lifecycle follows the
        server's); register workloads for unattended replanning via
        ``server.recalib.watch(gg, topo)``.

        ``health=True`` attaches a ``RunHealthAnalyzer`` draining the
        service's telemetry dir with its OWN cursor (it never steals
        the recalibration loop's records); ``slo_s``/``alert_rules``
        arm step-time SLO burn-rate alerting, and the recalibration
        loop replans drifted workloads in the analyzer's severity
        order. Register predicted schedules via
        ``server.health.watch(run_id, timeline=...)``.
        """
        from repro_torch.obs.collector import SpoolWriter, TraceCollector
        from repro_torch.obs.server import ObsServer
        spool = collector = loop = analyzer = None
        if spool_dir:
            spool = SpoolWriter(spool_dir, run_id=run_id, name="planner")
            collector = TraceCollector(spool_dir)
        if health:
            from repro_torch.obs.health import RunHealthAnalyzer
            from repro_torch.runtime.telemetry import MeasurementStore
            hstore = MeasurementStore(self._telemetry_dir) \
                if self._telemetry_dir else None
            analyzer = RunHealthAnalyzer(
                hstore, registry=self.metrics, slo_s=slo_s,
                alert_rules=alert_rules)
        if recalibrate:
            from repro_torch.runtime.feedback import RecalibrationLoop
            loop = RecalibrationLoop(self, interval_s=interval_s,
                                     iterations=iterations,
                                     health=analyzer)
        server = ObsServer(registry=self.metrics, service=self,
                           collector=collector, spool=spool, recalib=loop,
                           health=analyzer, host=host, port=port,
                           spool_max_age_s=spool_max_age_s,
                           spool_max_bytes=spool_max_bytes)
        return server.start() if start else server
