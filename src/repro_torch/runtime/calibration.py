"""Cost-model calibration from step telemetry (paper §4.3).

``fit_profile`` turns a set of observed ``StepRecord``s into a
``CalibrationProfile``:

  * per-device-type compute utilization — least squares of observed op
    time against ``flops / peak_flops`` (``core.profiler.fit_utilization``)
  * per-link-class comm regressions — alpha (per-transfer latency) and
    beta (achieved fraction of nominal bandwidth) fitted jointly per
    class ``p2p`` / ``intra`` / ``cross`` (``core.profiler.fit_comm``)

``CalibrationProfile.apply(topo)`` produces a topology whose device
speeds and efficiency factors are the MEASURED ones; ``core.simulator
.simulate(tg, topo, profile=...)`` and the planner consume it in place of
the hard-coded ``GPU_PEAKS`` utilization priors and ``Topology``
effective-bandwidth constants.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
import json
import os

import numpy as np

from repro_torch.core.device import GPU_PEAKS, Topology, peak_flops
from repro_torch.core.profiler import CommFit, fit_comm, fit_utilization

PROFILE_VERSION = 1

# lat_mult per collective kind: how many per-transfer latency hits the
# cost model charges (see core.profiler allreduce/ps/transfer formulas)
def _lat_mult(kind: str, n_dev: int) -> float:
    if kind == "allreduce":
        return 2.0 * n_dev
    if kind == "ps":
        return 2.0
    return 1.0                       # xfer


@dataclass
class CalibrationProfile:
    """Measurement-fitted replacements for the simulator's cost constants."""
    util: dict = field(default_factory=dict)    # gpu_type -> utilization
    links: dict = field(default_factory=dict)   # p2p|intra|cross -> CommFit
    latency: float | None = None                # fitted per-transfer alpha
    n_records: int = 0
    meta: dict = field(default_factory=dict)
    # per-(gi, gj) link-pair fits: "gi-gj" -> CommFit. Fitted only once a
    # pair accumulates >= min_pair_samples transfers (fit_profile arg);
    # sparser pairs keep the per-class fit above. Pipeline boundary
    # transfers (repro_torch.exec.replay / runtime.executor) tag their samples
    # with the pair key that feeds this tier.
    pairs: dict = field(default_factory=dict)
    # per-op-type utilization buckets: "gpu_type/op" -> utilization, where
    # ``op`` is the sample's op attribution — the pipeline event kind
    # (F/B/W) from the exec engine/replay, or the dominant traced
    # primitive ("dot_general", ...) from the task-graph executor. An
    # observability tier on top of the per-device ``util`` the cost model
    # applies: it shows WHICH phase/op family drags a device's achieved
    # utilization down (surfaced by ``profile_metrics`` and
    # ``python -m repro_torch.service.cli metrics``).
    util_by_op: dict = field(default_factory=dict)

    def device_flops(self, gpu_type: str, default: float) -> float:
        u = self.util.get(gpu_type)
        if u is None:
            return default
        return peak_flops(gpu_type) * u

    def apply(self, topo: Topology) -> Topology:
        """Calibrated copy of ``topo``: fitted utilization replaces the
        ``GPU_PEAKS`` priors, fitted per-class efficiencies replace the
        ``coll_eff_*`` / ``p2p_eff`` constants, fitted alpha replaces the
        nominal latency. Unobserved types/classes keep nominal values."""
        t2 = copy.deepcopy(topo)
        for g in t2.groups:
            g.flops = self.device_flops(g.gpu_type, g.flops)
        if "p2p" in self.links:
            t2.p2p_eff = self.links["p2p"].eff
        if "intra" in self.links:
            t2.coll_eff_intra = self.links["intra"].eff
        if "cross" in self.links:
            t2.coll_eff_cross = self.links["cross"].eff
        if self.latency is not None:
            t2.latency = self.latency
        for pair, fit in self.pairs.items():
            gi, gj = (int(x) for x in pair.split("-"))
            if gi < t2.m and gj < t2.m:
                t2.pair_eff[(gi, gj)] = fit.eff
        if topo.name:
            t2.name = f"{topo.name}+calib"
        return t2

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {"version": PROFILE_VERSION, "util": self.util,
                "util_by_op": self.util_by_op,
                "links": {k: v.to_dict() for k, v in self.links.items()},
                "pairs": {k: v.to_dict() for k, v in self.pairs.items()},
                "latency": self.latency, "n_records": self.n_records,
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationProfile":
        if d.get("version") != PROFILE_VERSION:
            raise ValueError(f"calibration profile schema "
                             f"{d.get('version')} != {PROFILE_VERSION}")
        return cls(util={k: float(v) for k, v in d.get("util", {}).items()},
                   util_by_op={k: float(v)
                               for k, v in d.get("util_by_op", {}).items()},
                   links={k: CommFit.from_dict(v)
                          for k, v in d.get("links", {}).items()},
                   pairs={k: CommFit.from_dict(v)
                          for k, v in d.get("pairs", {}).items()},
                   latency=d.get("latency"),
                   n_records=int(d.get("n_records", 0)),
                   meta=d.get("meta", {}))

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_profile(path: str) -> CalibrationProfile:
    return CalibrationProfile.load(path)


def uniform_profile(topo: Topology, scale: float,
                    n_records: int = 0) -> CalibrationProfile:
    """Time-only calibration fallback: when telemetry carries wall times
    but no per-op/per-collective samples, assume a uniform cluster
    slowdown (``scale`` < 1) or speedup — every compute rate, link
    efficiency, and (inversely) the latency scales by it, so simulated
    makespans scale by ~1/scale (modulo the fixed per-op launch
    overhead)."""
    scale = float(np.clip(scale, 1e-3, 10.0))
    util = {}
    for g in topo.groups:
        if g.gpu_type in GPU_PEAKS:
            util[g.gpu_type] = float(np.clip(
                g.flops * scale / peak_flops(g.gpu_type), 1e-3, 1.0))
    links = {
        "p2p": CommFit(eff=float(np.clip(topo.p2p_eff * scale, 1e-3, 1.0)),
                       alpha=topo.latency / scale),
        "intra": CommFit(eff=float(np.clip(topo.coll_eff_intra * scale,
                                           1e-3, 1.0)),
                         alpha=topo.latency / scale),
        "cross": CommFit(eff=float(np.clip(topo.coll_eff_cross * scale,
                                           1e-3, 1.0)),
                         alpha=topo.latency / scale),
    }
    return CalibrationProfile(
        util=util, links=links, latency=topo.latency / scale,
        n_records=n_records,
        meta={"topo": topo.name, "uniform_scale": scale,
              "compute_samples": 0, "comm_samples": 0})


def fit_profile(records: list, topo: Topology, *,
                min_pair_samples: int = 8) -> CalibrationProfile:
    """Fit a CalibrationProfile from observed StepRecords.

    ``topo`` is the NOMINAL topology the samples were recorded against —
    it supplies peak specs, the latency prior for rank-deficient comm
    fits, and names which device types exist.

    Per-link-pair tier: collective samples carrying a ``"pair"`` key
    ("gi-gj", e.g. pipeline boundary transfers) are additionally
    bucketed per pair; every pair with at least ``min_pair_samples``
    observations gets its own (eff, alpha) fit — sparser pairs fall back
    to the per-class fit.
    """
    by_type: dict = {}
    by_op: dict = {}
    for r in records:
        for s in r.compute:
            if s.get("flops", 0.0) > 0 and s.get("time", 0.0) > 0:
                sample = (float(s["flops"]), float(s["time"]))
                by_type.setdefault(s["gpu_type"], []).append(sample)
                op = s.get("op") or s.get("kind")
                if op:
                    by_op.setdefault((s["gpu_type"], str(op)),
                                     []).append(sample)
    util = {}
    for t, samples in by_type.items():
        if t not in GPU_PEAKS:
            continue
        fl, ti = zip(*samples, strict=True)
        u = fit_utilization(fl, ti, peak_flops(t))
        if u is not None:              # degenerate fit: keep nominal
            util[t] = u
    util_by_op = {}
    for (t, op), samples in by_op.items():
        if t not in GPU_PEAKS:
            continue
        fl, ti = zip(*samples, strict=True)
        u = fit_utilization(fl, ti, peak_flops(t))
        if u is not None:
            util_by_op[f"{t}/{op}"] = u

    by_class: dict = {}
    by_pair: dict = {}
    for r in records:
        for s in r.collectives:
            nb, nd = float(s.get("nbytes", 0.0)), int(s.get("n_dev", 2))
            bw, dt = float(s.get("nominal_bw", 0.0)), float(
                s.get("time", 0.0))
            if nb <= 0 or bw <= 0 or dt <= 0 or nd <= 1:
                continue
            kind = s.get("kind", "xfer")
            ring = 2.0 * (nd - 1) / nd if kind in ("allreduce", "ps") \
                else 1.0
            sample = (ring * nb / bw, _lat_mult(kind, nd), dt)
            by_class.setdefault(s.get("link", "p2p"), []).append(sample)
            if s.get("pair"):
                by_pair.setdefault(str(s["pair"]), []).append(sample)
    links = {}
    alphas = []
    for cls_name, samples in by_class.items():
        s, m, y = (list(x) for x in zip(*samples, strict=True))
        fit = fit_comm(s, m, y, prior_alpha=topo.latency)
        if fit is None:                # degenerate fit: keep nominal
            continue
        links[cls_name] = fit
        alphas.extend([fit.alpha] * fit.n_samples)
    pairs = {}
    for pair, samples in by_pair.items():
        if len(samples) < min_pair_samples:
            continue                   # sparse pair: class fit covers it
        s, m, y = (list(x) for x in zip(*samples, strict=True))
        fit = fit_comm(s, m, y, prior_alpha=topo.latency)
        if fit is not None:
            pairs[pair] = fit

    return CalibrationProfile(
        util=util, util_by_op=util_by_op, links=links, pairs=pairs,
        latency=float(np.mean(alphas)) if alphas else None,
        n_records=len(records),
        meta={"topo": topo.name,
              "compute_samples": int(sum(len(v) for v in by_type.values())),
              "comm_samples": int(sum(len(v) for v in by_class.values())),
              "pair_samples": {k: len(v) for k, v in by_pair.items()},
              "op_samples": {f"{t}/{op}": len(v)
                             for (t, op), v in by_op.items()}})


def profile_metrics(profile: CalibrationProfile, registry=None):
    """Surface a ``CalibrationProfile`` as metrics gauges
    (``repro_torch.obs.metrics``): per-device-type and per-op-type utilization,
    per-class and per-pair link efficiency, fitted latency. Returns the
    registry (created when not given)."""
    if registry is None:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
    g_util = registry.gauge("calibration_utilization",
                            "fitted compute utilization per device type")
    for t, u in profile.util.items():
        g_util.set(u, gpu_type=t)
    g_op = registry.gauge(
        "calibration_utilization_by_op",
        "fitted compute utilization per (device type, op type) bucket")
    for key, u in profile.util_by_op.items():
        t, op = key.split("/", 1)
        g_op.set(u, gpu_type=t, op=op)
    g_eff = registry.gauge("calibration_link_efficiency",
                           "fitted achieved fraction of nominal bandwidth")
    for cls_name, fit in profile.links.items():
        g_eff.set(fit.eff, link=cls_name)
    for pair, fit in profile.pairs.items():
        g_eff.set(fit.eff, link="pair", pair=pair)
    if profile.latency is not None:
        registry.gauge("calibration_latency_seconds",
                       "fitted per-transfer latency alpha").set(
            profile.latency)
    registry.gauge("calibration_records",
                   "step records the profile was fitted from").set(
        profile.n_records)
    return registry
