#!/usr/bin/env python3
"""``chip_smoke.py``'s ``service`` phase alone on one NVIDIA GPU, with the
steps of the earlier phases that it reads: the full-width qwen2-1.5b
training graph traced and searched (the ``plan`` phase's ``plan_trace`` and
``plan_search``), then ``run_pipeline`` with the hand-built 2-stage plan,
once with each engine (the ``pipeline`` phase's ``pipeline_run``), whose
telemetry the H100 calibration fits.

    python3 scripts/service_phase.py [--seed 0]

Prints the phases' lines as ``chip_smoke.py`` does, then the service
phase's seconds and its kernel launch counts; exits 1 when a gate fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.phase_env()
    qwen_gg, qwen_plan = cs.plan_search(cs.QWEN, cs.plan_trace(cs.QWEN, smi), smi)
    records = []
    cs.pipeline_run(torch.device("cuda", 0), args.seed, None, smi, searched=False,
                    stage_flops=qwen_gg.base.total_flops() / 2, telemetry=records)
    cs.reset_counts()
    t1 = time.perf_counter()
    cs.phase_service(args.seed, records, qwen_gg, qwen_plan, smi)
    counts = cs.read_counts()
    cs.log("service", f"{time.perf_counter() - t1:.1f} s; kernel launches {counts}; "
                      f"{time.perf_counter() - t0:.1f} s in all")
    return 1 if any(counts.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
