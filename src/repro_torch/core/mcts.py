"""GNN-guided Monte-Carlo tree search (paper §4.2.2).

Vertices are partial strategies; level k decides the deployment of the
k-th op group in descending computation-time order. Edge statistics
(visit count N, running-average reward Q) drive PUCT selection:

    U(s,a) = Q(s,a) + c * G(s,a) * sqrt(sum_a' N(s,a')) / (1 + N(s,a))

Rewards are simulated speed-ups over the DP-AllReduce baseline (OOM = -1,
paper's interactive OOM-rejection). Priors G come from the heterogeneous
GNN fed with the partial strategy + its simulated runtime feedback; a
uniform prior gives the "pure MCTS" ablation (Table 7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
import math

import numpy as np

from repro_torch.core.compiler import compile_strategy
from repro_torch.core.device import Topology
from repro_torch.core.features import featurize
from repro_torch.core.graph import GroupedGraph
from repro_torch.core.simulator import simulate
from repro_torch.core.strategy import (
    Action, Option, Strategy, candidate_actions, data_parallel_all)
from repro_torch.obs.spans import get_tracer


@dataclass
class Vertex:
    strategy: Strategy
    depth: int                       # number of decided groups
    actions: list | None = None      # candidates for the next group
    prior: np.ndarray | None = None
    N: np.ndarray | None = None
    Q: np.ndarray | None = None
    children: dict = field(default_factory=dict)
    reward: float = 0.0
    feedback: object = None          # SimResult of the filled strategy


@dataclass
class SearchResult:
    best_strategy: Strategy
    best_reward: float
    best_time: float
    baseline_time: float
    iters_to_beat_baseline: int      # -1 if never
    rewards: list
    visit_records: list              # (featurized state, gid, actions, pi)
    iterations_run: int = 0          # playouts actually executed
    warm_started: bool = False       # seeded from a prior strategy
    # best strategy among the playouts whose FILLED strategy pipelines
    # (None when no playout did) — diagnostic view of the pipe-subspace
    # decision when the overall winner is a single-mesh plan
    best_pipelined: Strategy | None = None
    best_pipelined_reward: float = float("-inf")


class MCTS:
    def __init__(self, gg: GroupedGraph, topo: Topology, *, policy=None,
                 c_puct: float = 1.5, seed: int = 0,
                 record_threshold: int = 8,
                 prior_strategy: Strategy | None = None,
                 prior_weight: float = 0.5,
                 observed_feedback=None,
                 schedule_aware: bool = True,
                 pipe_global_micro: int = 16):
        self.gg = gg
        self.topo = topo
        self.policy = policy          # callable(hetgraph, gid, actions)->probs
        self.c = c_puct
        # schedule-aware PIPE costing: pipelined strategies are ranked by
        # the schedule timeline simulator (bubble fraction + boundary
        # transfers under a memory-capped microbatch depth) instead of the
        # generic task-graph FIFO model; False = the PR-4-era FIFO ablation
        self.schedule_aware = schedule_aware
        self.pipe_global_micro = pipe_global_micro
        self._pipe_cache: dict = {}   # (partition, schedule) -> (step, res)
        # runtime feedback (paper §4.3): when a deployed plan's measured
        # step telemetry is available, its SimResult-shaped aggregate
        # overrides the simulated feedback features the GNN sees
        self.observed_feedback = observed_feedback
        self.rng = np.random.default_rng(seed)
        self.order = gg.sorted_by_cost()
        self.record_threshold = record_threshold
        # warm start (planner service): a previously-searched strategy whose
        # actions bias the priors and seed the first playout
        if prior_strategy is not None \
                and len(prior_strategy.actions) != gg.n:
            raise ValueError("prior_strategy has wrong group count")
        if prior_strategy is not None:
            # plans cached before PIPE actions carried a schedule store
            # schedule="" — candidate_actions only emits named variants
            # now, so normalize to the legacy default (1f1b) or the
            # blend/seed lookups would silently never match them
            prior_strategy = Strategy([
                Action(a.placement, a.option, schedule="1f1b")
                if a is not None and a.option == Option.PIPE
                and not a.schedule and len(a.placement) > 1 else a
                for a in prior_strategy.actions])
        self.prior_strategy = prior_strategy
        self.prior_weight = prior_weight

        base = Strategy([data_parallel_all(topo)] * gg.n)
        res = simulate(compile_strategy(gg, base, topo), self.topo)
        self.baseline_time = res.makespan
        self.default_action = data_parallel_all(topo)
        # episode-static featurization for embedding-caching policies: the
        # DP-baseline SimResult stands in as the episode's runtime-feedback
        # signal (deterministic, available before any playout)
        self._baseline_res = res
        self._static_het = None

    # ---------------------------------------------------------------- eval
    def _evaluate(self, strat: Strategy):
        filled = strat.fill_undecided(self._fill_action(strat))
        if self.schedule_aware and filled.has_pipeline():
            out = self._pipe_evaluate(filled)
            if out is not None:
                return out
        with get_tracer().span("simulate", cat="mcts"):
            tg = compile_strategy(self.gg, filled, self.topo)
            res = simulate(tg, self.topo)
        if not res.feasible:
            return -1.0, res
        return self.baseline_time / res.makespan, res

    def _pipe_evaluate(self, filled: Strategy):
        """Schedule-aware reward of a pipelined strategy: cut it into a
        StagePlan, run the voted microbatch schedule through the timeline
        simulator at the memory-capped feasible depth, and charge flushes
        plus the per-stage gradient sync. Results are memoized per
        (partition, schedule) — the timeline is episode-static, and many
        playouts land on the same cut. Returns None when the strategy has
        no multi-group spine (the FIFO model stays in charge); an
        infeasible memory cap is the paper's interactive OOM-rejection
        (-1 reward)."""
        # lazy import: repro.exec sits above core in the layering
        from repro_torch.exec.schedule import (
            schedule_step_cost, timeline_to_simresult)
        from repro_torch.exec.stages import build_stage_plan
        plan = build_stage_plan(self.gg, filled, self.topo,
                                n_micro=self.pipe_global_micro)
        if plan is None:
            return None
        key = (plan.placement, plan.schedule,
               tuple(tuple(s.op_group_ids) for s in plan.stages),
               tuple(s.sync for s in plan.stages))
        hit = self._pipe_cache.get(key)
        if hit is None:
            cost = schedule_step_cost(plan, self.topo, plan.schedule,
                                      global_micro=self.pipe_global_micro)
            if cost is None:
                hit = (None, None)
            else:
                res = timeline_to_simresult(
                    plan, cost["timeline"], self.topo, self.gg,
                    flushes=cost["flushes"],
                    sync_time=cost["sync_time_s"])
                hit = (cost["step_time_s"], res)
            self._pipe_cache[key] = hit
        step, res = hit
        if step is None:
            return -1.0, res
        return self.baseline_time / step, res

    def _fill_action(self, strat: Strategy):
        """Paper footnote 2: undecided groups copy the strategy of the most
        computation-expensive decided group."""
        for gid in self.order:
            if strat.actions[gid] is not None:
                return strat.actions[gid]
        return self.default_action

    def _episode_het(self):
        """Featurization shared by every expansion of this search: empty
        strategy, baseline runtime feedback, no next-group marker. Policies
        advertising ``cache_embeddings`` receive this same HetGraph at every
        vertex, so their encoder memoization collapses ``gnn_forward`` to
        one run per episode (the decoder still sees per-vertex actions)."""
        if self._static_het is None:
            self._static_het = featurize(
                self.gg, self.topo, Strategy.empty(self.gg.n),
                self._baseline_res, None, observed=self.observed_feedback)
        return self._static_het

    def _priors(self, vertex: Vertex):
        gid = self.order[vertex.depth]
        actions = candidate_actions(
            self.topo, has_grad=self.gg.groups[gid].has_grad)
        if self.policy is None:
            probs = np.full(len(actions), 1.0 / len(actions))
        else:
            tracer = get_tracer()
            if getattr(self.policy, "cache_embeddings", False):
                het = self._episode_het()
            else:
                with tracer.span("featurize", cat="mcts"):
                    het = featurize(self.gg, self.topo, vertex.strategy,
                                    vertex.feedback, gid,
                                    observed=self.observed_feedback)
            with tracer.span("gnn_forward", cat="mcts"):
                probs = np.asarray(self.policy(het, gid, actions),
                                   np.float64)
            probs = probs / max(probs.sum(), 1e-9)
        return actions, self._blend_prior(gid, actions, probs)

    def _blend_prior(self, gid: int, actions, probs):
        """Mix prior mass toward the warm-start strategy's action."""
        if self.prior_strategy is None:
            return probs
        pa = self.prior_strategy.actions[gid]
        if pa is None or pa not in actions:
            return probs
        onehot = np.zeros(len(actions))
        onehot[actions.index(pa)] = 1.0
        return (1.0 - self.prior_weight) * probs + self.prior_weight * onehot

    def _expand(self, v: Vertex):
        if v.depth < self.gg.n and v.actions is None:
            v.actions, v.prior = self._priors(v)
            v.N = np.zeros(len(v.actions))
            # First-play urgency: unvisited actions start at the vertex's
            # own evaluation instead of 0. Deciding one more group often
            # fills to the SAME complete strategy as the parent (footnote-2
            # fill), so the child's reward exactly repeats the parent's —
            # with Q(unvisited)=0 such a plateau child outranks every
            # unexplored sibling and a small-budget search marches down a
            # constant-reward chain, learning nothing per playout (the
            # schedule-aware PIPE rewards made these plateaus common
            # enough to trap the policy-training searches). At Q=v.reward
            # a plateau child ties its siblings and the prior-weighted
            # exploration term decides; the init washes out on the first
            # real visit (running average with N=1 sets Q=r).
            v.Q = np.full(len(v.actions), v.reward)

    def _backprop(self, path, r):
        for (pv, ai) in path:
            pv.N[ai] += 1
            pv.Q[ai] += (r - pv.Q[ai]) / pv.N[ai]

    def _seed_playout(self, root: Vertex):
        """Warm-start playout (planner service): descend along the prior
        strategy's actions, expanding vertices and creating children on the
        way, so the first evaluation is the full prior strategy and its path
        carries visit statistics like any other iteration. Returns None —
        charging no playout — when no prior action applies at the root."""
        v = root
        path = []
        while v.depth < self.gg.n:
            self._expand(v)
            gid = self.order[v.depth]
            pa = self.prior_strategy.actions[gid]
            if pa is None or pa not in v.actions:
                break
            a_idx = v.actions.index(pa)
            path.append((v, a_idx))
            if a_idx not in v.children:
                v.children[a_idx] = Vertex(
                    v.strategy.with_action(gid, pa), v.depth + 1)
            v = v.children[a_idx]
        if not path:
            return None
        r, res = self._evaluate(v.strategy)
        v.reward, v.feedback = r, res
        self._expand(v)
        self._backprop(path, r)
        return r, v

    # -------------------------------------------------------------- search
    def search(self, iterations: int = 100, *,
               stop_reward: float | None = None) -> SearchResult:
        root = Vertex(Strategy.empty(self.gg.n), 0)
        root.reward, root.feedback = self._evaluate(root.strategy)
        best = {"r": root.reward, "s": root.strategy, "iters": -1,
                "pipe_r": float("-inf"), "pipe_s": None}
        rewards = []
        records = []
        it_run = 0

        def note(r, v):
            nonlocal it_run
            it_run += 1
            rewards.append(r)
            if r > best["r"]:
                best["r"], best["s"] = r, v.strategy
            if best["iters"] < 0 and r > 1.0:
                best["iters"] = it_run
            if r > best["pipe_r"]:      # guard keeps the re-fill off the
                #                         common path (rarely improves)
                filled_v = v.strategy.fill_undecided(
                    self._fill_action(v.strategy))
                if filled_v.has_pipeline():
                    best["pipe_r"], best["pipe_s"] = r, filled_v

        if self.prior_strategy is not None and iterations > 0:
            seeded = self._seed_playout(root)
            if seeded is not None:
                note(*seeded)

        tracer = get_tracer()
        while it_run < iterations:
            if stop_reward is not None and best["r"] >= stop_reward:
                break
            with tracer.span("playout", cat="mcts", iter=it_run):
                # selection
                path = []
                v = root
                while True:
                    if v.depth >= self.gg.n:
                        break
                    if v.actions is None:  # unexpanded leaf
                        break
                    total_n = v.N.sum()
                    u = v.Q + self.c * v.prior \
                        * math.sqrt(total_n + 1e-9) / (1.0 + v.N)
                    a_idx = int(np.argmax(u))
                    path.append((v, a_idx))
                    if a_idx not in v.children:
                        gid = self.order[v.depth]
                        child = Vertex(
                            v.strategy.with_action(gid, v.actions[a_idx]),
                            v.depth + 1)
                        v.children[a_idx] = child
                        v = child
                        break
                    v = v.children[a_idx]

                # expansion + evaluation
                with tracer.span("evaluate", cat="mcts", depth=v.depth):
                    r, res = self._evaluate(v.strategy)
                v.reward, v.feedback = r, res
                with tracer.span("expand", cat="mcts"):
                    self._expand(v)

                # back-propagation
                self._backprop(path, r)
                note(r, v)

        # collect training records from well-visited vertices
        def visit(v):
            if v.actions is not None and v.N is not None \
                    and v.N.sum() >= self.record_threshold:
                pi = np.log(np.maximum(v.N, 1e-9))
                pi = np.exp(pi - pi.max())
                pi = pi / pi.sum()
                gid = self.order[v.depth]
                het = featurize(self.gg, self.topo, v.strategy,
                                v.feedback, gid,
                                observed=self.observed_feedback)
                records.append((het, gid, v.actions, pi))
            for ch in v.children.values():
                visit(ch)
        visit(root)

        filled = best["s"].fill_undecided(self._fill_action(best["s"]))
        return SearchResult(
            best_strategy=filled,
            best_reward=best["r"],
            best_time=self.baseline_time / max(best["r"], 1e-9)
            if best["r"] > 0 else float("inf"),
            baseline_time=self.baseline_time,
            iters_to_beat_baseline=best["iters"],
            rewards=rewards,
            visit_records=records,
            iterations_run=it_run,
            warm_started=self.prior_strategy is not None,
            best_pipelined=best["pipe_s"],
            best_pipelined_reward=best["pipe_r"])
