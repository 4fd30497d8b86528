#!/usr/bin/env python3
"""``chip_smoke.py``'s ``pipeline`` phase alone on NVIDIA GPUs: the
gradient gates of both engines (qwen2-1.5b at full width and 4 layers, f32,
every schedule, AR, PS and SFB at 2 shards a stage; olmoe-1b-7b with AR),
with a stage's shards on distinct cards where the host has 2 or more, then
``run_pipeline`` and ``build_pipeline`` of full-depth bf16 qwen2-1.5b with
the searched and the hand-built plan, once with each engine.

    python3 scripts/pipeline_phase.py [--seed 0] [--gates-only]

Prints the phase's lines as ``chip_smoke.py`` does, then its seconds;
exits 1 when a gate fails.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gates-only", action="store_true",
                    help="the gradient gates alone, without the full-depth runs")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.phase_env()
    dev = torch.device("cuda", 0)
    try:
        cs.pipeline_gate(dev, args.seed, smi)
        cs.pipeline_gate_moe(dev, args.seed, smi)
        t1 = time.perf_counter()
        if not args.gates_only:
            cs.pipeline_run(dev, args.seed, None, smi)
            cs.pipeline_run(dev, args.seed, None, smi, searched=False)
    except Exception:
        traceback.print_exc()
        print("[pipeline] FAILED", flush=True)
        return 1
    cs.log("pipeline", f"gates {t1 - t0:.1f} s, runs {time.perf_counter() - t1:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
