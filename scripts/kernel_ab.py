#!/usr/bin/env python3
"""Time the port's two hand-written CUDA kernels against earlier versions of
their sources, in turns, on one NVIDIA GPU.

    git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu > build/ab/flash_attention.cu
    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > build/ab/ssd_scan.cu
    python3 scripts/kernel_ab.py --old-dir build/ab [--rounds 2]

The earlier sources must export the same C functions with the same
arguments (``flash_attention_fwd``, ``ssd_scan_fwd``). Both versions are
built with ``nvcc`` as the port builds its own, run once at the serve paths'
shapes and checked against the plain version, then timed (device time of a
CUDA graph of back-to-back launches, ``chip_smoke.graph_ms``) in the order
old, new, new, old (``--rounds`` times), beside
``scaled_dot_product_attention`` for the flash kernel. Prints the card's
name and power limit and, as the last line, one JSON object with every
time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (shapes, inputs, timing, gates)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ref import ref_gqa_attention  # noqa: E402

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
ARGTYPES = {
    # q, k, v, o, B, S, H, KV, hd, causal, window, scale, is_bf16, stream
    "flash_attention": ("flash_attention_fwd", [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float,
                                                I, P]),
    # x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y, h, Bb, S, nh, hd, g, ds, Q, is_bf16, stream
    "ssd_scan": ("ssd_scan_fwd", [P, L, L, P, P, P, L, L, P, L, L, P, P,
                                  I, I, I, I, I, I, I, I, P]),
}


def entry(name: str, csrc: Path):
    fn_name, argtypes = ARGTYPES[name]
    fn = getattr(ctypes.CDLL(str(build.build(name, csrc).path)), fn_name)
    fn.argtypes, fn.restype = argtypes, I
    return fn


def flash_call(fn, q, k, v, o):
    B, S, H, hd = q.shape

    def run():   # on the current stream, which a CUDA graph's capture replaces
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H, k.shape[2], hd,
                 1, 0, hd ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    return run


def ssd_call(fn, x, dt, A, B, C, y, h, chunk):
    Bb, S, nh, hd = x.shape

    def run():
        err = fn(x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(),
                 B.data_ptr(), B.stride(0), B.stride(1), C.data_ptr(), C.stride(0), C.stride(1),
                 y.data_ptr(), h.data_ptr(), Bb, S, nh, hd, B.shape[2], B.shape[3], chunk, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan_fwd: CUDA error {err}")
    return run


def in_turns(runs: dict, rounds: int, iters: int) -> dict:
    """Device times (ms, CUDA-graph replay) of each version, in the order
    old, new, new, old."""
    times = {k: [] for k in runs}
    for _ in range(rounds):
        for key in ("old", "new", "new", "old"):
            times[key].append(cs.graph_ms(runs[key], iters))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(args.seed)
    out = {"device": smi}

    _, B, S, H, KV, hd, causal, window, dt = cs.FLASH_CASES[0]
    q, k, v = cs._rand(rng, (B, S, H, hd), dt), cs._rand(rng, (B, S, KV, hd), dt), \
        cs._rand(rng, (B, S, KV, hd), dt)
    ref = ref_gqa_attention(q, k, v, causal=causal, window=window).float()
    runs, errs = {}, {}
    for key, csrc in (("old", args.old_dir), ("new", build.CSRC)):
        o = torch.empty_like(q)
        runs[key] = flash_call(entry("flash_attention", csrc), q, k, v, o)
        runs[key]()
        torch.cuda.synchronize()
        errs[key] = (o.float() - ref).abs().max().item()
        if errs[key] > cs.KERNEL_ATOL[dt]:
            raise RuntimeError(f"{key} flash kernel disagrees with the plain version: {errs[key]}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    times = in_turns(runs, args.rounds, 50)
    times["sdpa"] = [cs.graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 50) for _ in range(args.rounds)]
    out["flash_attention"] = {"shape": [B, S, H, KV, hd], "max_abs_err": errs, "ms": times}
    print(f"flash_attention B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal, ms in turns "
          f"(old, new, new, old): old {times['old']} new {times['new']} sdpa {times['sdpa']}",
          flush=True)

    _, Bb, S, nh, hd, g, ds, chunk, dt = cs.SSD_CASES[0]
    x, dtv, A, Bm, Cm = cs._ssd_inputs(rng, Bb, S, nh, hd, g, ds, dt, strided=True)
    yr, _ = cs.plain_ssd(x, dtv, A, Bm, Cm, chunk)
    runs, errs = {}, {}
    for key, csrc in (("old", args.old_dir), ("new", build.CSRC)):
        y = torch.empty((Bb, S, nh, hd), dtype=dt, device="cuda")
        h = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device="cuda")
        runs[key] = ssd_call(entry("ssd_scan", csrc), x, dtv, A, Bm, Cm, y, h, chunk)
        runs[key]()
        torch.cuda.synchronize()
        errs[key] = (y.float() - yr.float()).abs().max().item()
        if errs[key] > cs.SSD_ATOL[dt]:
            raise RuntimeError(f"{key} SSD kernel disagrees with the plain version: {errs[key]}")
    times = in_turns(runs, args.rounds, 20)
    out["ssd_scan"] = {"shape": [Bb, S, nh, hd, g, ds, chunk], "max_abs_err": errs, "ms": times}
    print(f"ssd_scan Bb={Bb} S={S} nh={nh} hd={hd} g={g} ds={ds} chunk={chunk} bf16 strided, "
          f"ms in turns (old, new, new, old): old {times['old']} new {times['new']}", flush=True)

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
