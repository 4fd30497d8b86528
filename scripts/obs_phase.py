#!/usr/bin/env python3
"""``chip_smoke.py``'s ``obs`` phase alone on one NVIDIA GPU, with the
steps of the earlier phases that it reads: the ``plan`` phase's ``train
--tag-search`` command (the unprofiled losses), then ``run_pipeline`` with
the hand-built 2-stage plan, once with each engine (the ``pipeline``
phase's ``pipeline_run``), tracing and spooling for the obs phase.

    python3 scripts/obs_phase.py [--seed 0]

Prints the phases' lines as ``chip_smoke.py`` does, then the obs phase's
seconds and its kernel launch counts; exits 1 when a gate fails.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
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
    root = Path(tempfile.mkdtemp(prefix="obs_phase_"))
    try:
        losses = cs.plan_tag_search(smi)
        runs = cs.pipeline_run(torch.device("cuda", 0), args.seed, None, smi, searched=False,
                               obs_root=root)
        cs.reset_counts()
        t1 = time.perf_counter()
        cs.phase_obs(root, losses, runs["eager"], smi)
        counts = cs.read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cs.log("obs", f"{time.perf_counter() - t1:.1f} s; kernel launches {counts}; "
                  f"{time.perf_counter() - t0:.1f} s in all")
    return 1 if any(counts.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
