#!/usr/bin/env python3
"""``chip_smoke.py``'s ``tp``, ``fsdp`` and ``dryrun`` phases alone on one
NVIDIA GPU: tensor parallelism over ``"model"`` with ``[cuda:0] * 4``
standing for the mesh's positions (the gradient and train-step gate on
full-width models at 4 and 2 layers, then the full-depth prefills of
qwen2-1.5b and mamba2-130m through the hand kernels over (2, 2) and (1, 4)
and ``generate``), parameters split over ``"data"`` (FSDP: the same gates
with ``embed=data`` and ``expert_embed=data``), and the dry run on ``meta``
tensors, in a process of its own beside them, as the smoke runs it.

    python3 scripts/tp_phase.py [--seed 0]

Prints the phases' lines as ``chip_smoke.py`` does, then their seconds;
exits 1 when a gate fails.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = cs.phase_env()
    dry = cs.start_dryrun(smi)
    try:
        counts = cs.phase_tp(args.seed, smi)
        t1 = time.perf_counter()
        fsdp = cs.phase_fsdp(args.seed, smi)
        t2 = time.perf_counter()
        cs.finish_dryrun(dry, timeout=cs.DRYRUN_WAIT_S)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
    cs.log("tp", f"prefill launches: tp {counts}, fsdp {fsdp}; tp {t1 - t0:.1f} s, fsdp "
                 f"{t2 - t1:.1f} s, then waited {time.perf_counter() - t2:.1f} s for the dry "
                 f"run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
