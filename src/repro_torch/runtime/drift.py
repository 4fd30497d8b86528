"""Drift detection: observed step time vs a cached plan's simulated
makespan.

Transient spikes are damped two ways, both configurable (and plumbed
through ``PlannerService(drift_threshold=, drift_min_samples=,
drift_ewma_alpha=)``): observed step times are smoothed by an
exponentially-weighted moving average per (graph, topology) key, and
drift is only flagged once ``min_samples`` observations put the smoothed
value beyond ``threshold`` relative error. With the defaults
(``min_samples=1``, ``alpha=0.5``) a first-ever observation can trigger
immediately; raise ``min_samples`` to require sustained drift.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DriftReport:
    graph_fp: str
    topo_fp: str
    simulated: float              # cached plan's simulated step seconds
    observed: float               # latest observed step seconds
    ewma: float                   # smoothed observed step seconds
    drift: float                  # |ewma - simulated| / simulated
    threshold: float
    n_obs: int
    drifted: bool
    # attributed root cause of a drifted verdict, stamped by the
    # recalibration path from the run-health analyzer:
    # {"cause": "stage"|"link"|"sync", "key", "residual_s", ...}.
    # None when no analyzer observed the drifting run.
    cause: dict | None = None

    def to_dict(self) -> dict:
        return {"graph_fp": self.graph_fp, "topo_fp": self.topo_fp,
                "simulated": self.simulated, "observed": self.observed,
                "ewma": self.ewma, "drift": self.drift,
                "threshold": self.threshold, "n_obs": self.n_obs,
                "drifted": self.drifted, "cause": self.cause}


@dataclass
class _KeyState:
    ewma: float = 0.0
    n: int = 0


class DriftDetector:
    def __init__(self, threshold: float = 0.25, alpha: float = 0.5,
                 min_samples: int = 1):
        self.threshold = threshold
        self.alpha = alpha
        self.min_samples = max(min_samples, 1)
        self._state: dict = {}          # (graph_fp, topo_fp) -> _KeyState

    def update(self, graph_fp: str, topo_fp: str, simulated: float,
               observed: float) -> DriftReport:
        key = (graph_fp, topo_fp)
        st = self._state.setdefault(key, _KeyState())
        st.n += 1
        st.ewma = observed if st.n == 1 else (
            self.alpha * observed + (1.0 - self.alpha) * st.ewma)
        drift = abs(st.ewma - simulated) / simulated if simulated > 0 \
            else float("inf")
        return DriftReport(
            graph_fp=graph_fp, topo_fp=topo_fp, simulated=simulated,
            observed=observed, ewma=st.ewma, drift=drift,
            threshold=self.threshold, n_obs=st.n,
            drifted=st.n >= self.min_samples and drift > self.threshold)

    def reset(self, graph_fp: str, topo_fp: str):
        self._state.pop((graph_fp, topo_fp), None)
