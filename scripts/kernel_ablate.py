#!/usr/bin/env python3
"""Where the time of the port's two hand-written CUDA kernels goes: each
kernel with one part of its work taken out, timed beside the whole kernel on
one NVIDIA GPU.

    python3 scripts/kernel_ablate.py [--rounds 2]

Each variant is the kernel's source in ``src/repro_torch/kernels/csrc/`` with
one edit (listed in VARIANTS; an edit that no longer applies fails the run),
built with ``nvcc`` as the port builds its sources, into ``build/ablate/``.
Every variant but ``full`` computes a wrong result on purpose: what it
measures is the time the removed part costs. All are timed at the serve
paths' shapes (device time of a CUDA graph of back-to-back launches,
``chip_smoke.graph_ms``), in the order of VARIANTS and back, ``--rounds``
times, beside ``scaled_dot_product_attention`` for the flash kernel. Prints
the card's name and power limit and, as the last line, one JSON object with
every time.
"""
from __future__ import annotations

import argparse
import concurrent.futures
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
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402  (shapes, inputs and timing)
import kernel_ab as ab  # noqa: E402  (ctypes entry points and calls)
from repro_torch.kernels import build  # noqa: E402

# (source, variant): [(text, replacement), ...]
VARIANTS = {
    ("flash_attention", "full"): [],
    ("flash_attention", "one P V product (P in bf16)"): [
        ("            wgmma_rs(acc[c], pl[kk], dv);\n", "")],
    ("flash_attention", "no exp in the softmax"): [
        ("    sc[e] = exp2_approx(sc[e] - m[(e % 4) / 2]);",
         "    sc[e] = sc[e] - m[(e % 4) / 2];")],
    ("flash_attention", "no mask"): [
        ("softmax(sc, edge(k0), row0", "softmax(sc, false, row0")],
    ("flash_attention", "no Q K^T"): [
        ("        issue_qk(sc, s);\n", "        wgmma_commit();\n")],
    ("ssd_scan", "full"): [],
    ("ssd_scan", "no state update"): [("    if (hc < DSP) {", "    if (false && hc < DSP) {")],
    ("ssd_scan", "no intra-chunk term"): [
        ("        if (t0 >= QP || t0 > i0 + 15) continue;", "        continue;")],
    ("ssd_scan", "no carried-state term"): [
        ("      if (c > 0) {\n#pragma unroll\n        for (int ks = 0;",
         "      if (false) {\n#pragma unroll\n        for (int ks = 0;")],
    ("ssd_scan", "no y"): [("    if (i0 < QP) {", "    if (false && i0 < QP) {")],
    ("ssd_scan", "loads, scans and barriers only"): [
        ("    if (i0 < QP) {", "    if (false && i0 < QP) {"),
        ("    if (hc < DSP) {", "    if (false && hc < DSP) {")],
    ("ssd_scan", "loops not unrolled"): [
        ("  const bool full = Q == QMAX && ds == DSMAX;", "  const bool full = false;")],
}


def variant_source(name: str, edits) -> str:
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit {old[:60]!r} does not apply once")
        src = src.replace(old, new)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    dirs = {}
    for i, ((name, label), edits) in enumerate(VARIANTS.items()):
        d = ROOT / "build" / "ablate" / f"{name}_{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{name}.cu").write_text(variant_source(name, edits))
        dirs[(name, label)] = d
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda item: build.build(item[0][0], item[1]), dirs.items()))

    rng = np.random.default_rng(args.seed)
    _, B, S, H, KV, hd, _, _, dt = cs.FLASH_CASES[0]
    q, k, v = (cs._rand(rng, (B, S, n, hd), dt) for n in (H, KV, KV))
    _, Bb, S2, nh, hd2, g, ds, chunk, dt2 = cs.SSD_CASES[0]
    x, dtv, A, Bm, Cm = cs._ssd_inputs(rng, Bb, S2, nh, hd2, g, ds, dt2, strided=True)
    runs = {}
    for (name, label), d in dirs.items():
        fn = ab.entry(name, d)
        if name == "flash_attention":
            runs[(name, label)] = (ab.flash_call(fn, q, k, v, torch.empty_like(q)), 50)
        else:
            y = torch.empty((Bb, S2, nh, hd2), dtype=dt2, device="cuda")
            h = torch.empty((Bb, nh, hd2, ds), dtype=torch.float32, device="cuda")
            runs[(name, label)] = (ab.ssd_call(fn, x, dtv, A, Bm, Cm, y, h, chunk), 20)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    times = {f"{n}: {lab}": [] for n, lab in runs}
    times["flash_attention: scaled_dot_product_attention"] = []
    order = list(runs.items())
    for _ in range(args.rounds):
        for (name, label), (run, iters) in order + order[::-1]:
            times[f"{name}: {label}"].append(cs.graph_ms(run, iters))
        times["flash_attention: scaled_dot_product_attention"].append(cs.graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            50))
    for key, ms in times.items():
        print(f"{key}: {', '.join(f'{t:.4f}' for t in ms)} ms", flush=True)
    out = {"device": smi, "flash_shape": [B, S, H, KV, hd], "ssd_shape": [Bb, S2, nh, hd2, g, ds,
                                                                          chunk], "ms": times}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
