"""Profiler (paper §4.1.2).

Per-op compute times per device type follow the paper's finding that time
is (piecewise) linear in batch size: we model t(op, dev, frac) =
overhead + flops*frac / dev_throughput, and provide the measure-then-
regress pipeline (LinearBatchModel / SegmentedLinear) used to fit real
measurements — exercised on CPU in tests to validate the linearity
assumption, and used to fit GRPC/AllReduce-style comm curves.
"""
from __future__ import annotations

from dataclasses import dataclass
import time

import numpy as np
import torch

from repro_torch.launch.device import resolve_device

OP_OVERHEAD = 5e-6     # per-op launch overhead (s)


@dataclass
class LinearBatchModel:
    """t(batch) = a + b * batch, fit on profiled batch sizes (paper: <=60)."""
    a: float
    b: float

    @classmethod
    def fit(cls, batches, times) -> "LinearBatchModel":
        x = np.asarray(batches, float)
        y = np.asarray(times, float)
        b, a = np.polyfit(x, y, 1)
        return cls(a=float(max(a, 0.0)), b=float(max(b, 0.0)))

    def __call__(self, batch: float) -> float:
        return self.a + self.b * batch


@dataclass
class SegmentedLinear:
    """Piecewise-linear size->time model (paper: GRPC/NCCL regressions fit
    on 1KB..1GB doubling sizes)."""
    knots: np.ndarray      # sizes (sorted)
    times: np.ndarray

    @classmethod
    def fit(cls, sizes, times) -> "SegmentedLinear":
        order = np.argsort(sizes)
        return cls(np.asarray(sizes, float)[order],
                   np.asarray(times, float)[order])

    def __call__(self, size: float) -> float:
        k, t = self.knots, self.times
        if size <= k[0]:
            return float(t[0] * size / k[0])
        if size >= k[-1]:
            return float(t[-1] * size / k[-1])
        i = int(np.searchsorted(k, size)) - 1
        f = (size - k[i]) / (k[i + 1] - k[i])
        return float(t[i] + f * (t[i + 1] - t[i]))


def compute_time(flops: float, dev_flops: float, frac: float = 1.0) -> float:
    return OP_OVERHEAD + flops * frac / dev_flops


def transfer_time(nbytes: float, bw: float, latency: float) -> float:
    if nbytes <= 0:
        return 0.0
    return latency + nbytes / bw


def allreduce_time(nbytes: float, n_dev: int, bw: float,
                   latency: float) -> float:
    """Ring AllReduce: 2(D-1)/D * bytes / bottleneck_bw."""
    if n_dev <= 1 or nbytes <= 0:
        return 0.0
    return 2 * (n_dev - 1) / n_dev * nbytes / bw + 2 * n_dev * latency


def ps_round_time(nbytes: float, n_dev: int, bw: float,
                  latency: float) -> float:
    """Sharded PS (round-robin owners) push+pull for one worker's share."""
    if n_dev <= 1 or nbytes <= 0:
        return 0.0
    return 2 * (n_dev - 1) / n_dev * nbytes / bw + 2 * latency


# ----------------------------------------------- calibration primitives
# Least-squares fits of the cost model's free parameters from runtime
# telemetry (repro.runtime.calibration orchestrates these per device type
# / link class and packages the result as a CalibrationProfile).

def fit_utilization(flops, times, peak_flops: float,
                    overhead: float = OP_OVERHEAD) -> float | None:
    """Recover a device type's compute utilization from measured op times.

    Model: t = overhead + flops / (peak_flops * u). Least squares through
    the origin on (flops, t - overhead) gives 1/(peak*u); inverted and
    clamped to (0, 1]. Returns ``None`` when the samples carry no signal
    (all times at/under the launch overhead) — the caller keeps its
    nominal prior; a fabricated util=1.0 would move the cost model the
    WRONG way for a cluster that was observed to be slow.
    """
    x = np.asarray(flops, float)
    y = np.asarray(times, float) - overhead
    denom = float(np.sum(x * x))
    if denom <= 0:
        return None
    slope = float(np.sum(x * y)) / denom
    if slope <= 0:
        return None
    return float(min(1.0 / (slope * peak_flops), 1.0))


@dataclass
class CommFit:
    """Fitted link-class parameters: t = size_term / eff + lat_mult * alpha,
    where size_term is the transfer's byte volume normalized by the NOMINAL
    link bandwidth (so ``eff`` is the achieved fraction of nominal) and
    lat_mult counts per-transfer latency hits (1 for p2p, 2n for ring
    AllReduce, 2 for sharded PS)."""
    eff: float                 # achieved fraction of nominal bandwidth
    alpha: float               # per-hit latency (s)
    n_samples: int = 0

    def to_dict(self) -> dict:
        return {"eff": self.eff, "alpha": self.alpha,
                "n_samples": self.n_samples}

    @classmethod
    def from_dict(cls, d: dict) -> "CommFit":
        return cls(eff=float(d["eff"]), alpha=float(d["alpha"]),
                   n_samples=int(d.get("n_samples", 0)))


def fit_comm(size_terms, lat_mults, times,
             prior_alpha: float = 50e-6) -> CommFit | None:
    """Fit one link class's (eff, alpha) by least squares.

    Design matrix columns are [size_term, lat_mult]; the solution's first
    coefficient is 1/eff. Falls back to the prior latency (fitting eff
    alone through the origin) when the system is rank-deficient — e.g. a
    single sample, or all samples sharing one transfer size. Returns
    ``None`` when even that carries no signal (non-positive slope): the
    caller keeps its nominal efficiency rather than adopting a fabricated
    one.
    """
    s = np.asarray(size_terms, float)
    m = np.asarray(lat_mults, float)
    y = np.asarray(times, float)
    eff, alpha = 0.0, prior_alpha
    if len(s) >= 2:
        A = np.stack([s, m], axis=1)
        coef, _, rank, _ = np.linalg.lstsq(A, y, rcond=None)
        if rank == 2 and coef[0] > 0 and coef[1] >= 0:
            eff, alpha = 1.0 / float(coef[0]), float(coef[1])
    if eff <= 0:                       # fall back: alpha pinned to prior
        resid = y - prior_alpha * m
        denom = float(np.sum(s * s))
        slope = float(np.sum(s * resid)) / denom if denom > 0 else 0.0
        if slope <= 0:
            return None
        eff = 1.0 / slope
        alpha = prior_alpha
    return CommFit(eff=float(np.clip(eff, 1e-3, 1.0)), alpha=alpha,
                   n_samples=len(s))


# --------------------------------------------------------- measurement

def measure_op(fn, *args, device, repeats: int = 5) -> float:
    """Median time of one ``fn(*args)`` call on ``device``, after a warm-up
    call. On a CUDA device each call is timed with CUDA events; on the CPU
    with ``time.perf_counter``. Asking for CUDA without a card raises."""
    device = resolve_device(device)
    fn(*args)  # warm-up
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def profile_matmul_batches(batches, dim: int = 256, *, device) -> LinearBatchModel:
    """Measure ``torch.mm`` time of a (batch, dim) x (dim, dim) product vs
    batch size on ``device`` and fit the linear model (validates the
    paper's linearity assumption): bf16 on a CUDA device, f32 on the CPU."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    w = torch.ones((dim, dim), dtype=dtype, device=device)
    times = []
    for b in batches:
        x = torch.ones((int(b), dim), dtype=dtype, device=device)
        times.append(measure_op(torch.mm, x, w, device=device))
    return LinearBatchModel.fit(batches, times)
