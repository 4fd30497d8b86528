#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on one
NVIDIA GPU, through its hand-written CUDA kernels.

    python3 chip_smoke.py [--seed 0]

Phases, each printed on lines of its own and each fatal when it fails:

1. env     torch and CUDA versions, the card, its name and power limit.
2. build   every CUDA source of the port with nvcc for sm_90a, one nvcc per
           source, all started together; the ptxas report (registers,
           spills) and each kernel's shared memory.
3. kernel  each kernel against its plain PyTorch version on the card, at the
           serve paths' shapes, at the sweeps of tests/test_kernels.py and at
           the edges of each kernel's layout, then timed beside the plain
           version, one PyTorch library call where there is one, and the
           card's bound: device time from a CUDA graph of back-to-back calls
           (and, for comparison, eager calls timed with CUDA events); the
           launch (blocks against SMs, shared memory a block). Then both
           kernels at the other families' prefill shapes (flash: olmoe
           4 x 512 16/16 hd 128, jamba 32/8, musicgen 4 x 768 32/32 hd 64,
           internvl 4 x 768 48/8; SSD: jamba's 128 heads of 64, state 16),
           checked in f32 and bf16 and timed in bf16 beside SDPA and the
           bound.
4. serve   the main paths, each with every kernel count at 0 just before it,
           full width in bf16, random weights from ``--seed``, a prefill of
           4 prompts through the hand kernels (one launch a layer of the
           kernel's mixer), then ``generate`` of 32 greedy tokens:
           qwen2-1.5b (4 x 512, flash x 28), mamba2-130m (4 x 1024, SSD x
           24), olmoe-1b-7b (4 x 512, 64 experts top-8, flash x 16),
           jamba-v0.1-52b at one period of 8 layers (4 x 512, flash x 1, SSD
           x 7, MoE on every other layer), musicgen-large and internvl2-26b
           (4 x 512 behind a 256-token prefix, flash x 48 each). Each model
           is freed before the next.
5. profile where each serve path's time goes: torch.profiler over one
           prefill and over 8 decode steps of the same model, kernel time by
           group and the device's busy share.
6. parity  full width in f32: qwen2-1.5b prefill through the flash kernel
           against the plain chunked attention on the card; mamba2-130m
           prefill through the SSD kernel on the card against the plain
           chunked scan on the CPU, from a copy of the same weights.
7. train   the training path, with every kernel count at 0 just before it:
           full-width qwen2-1.5b (batch 8 x 512) and mamba2-130m (batch
           8 x 1024), all layers, and olmoe-1b-7b at 4 layers (8 x 512), bf16,
           6 steps of ``make_train_step`` (loss in chunks of 128, full
           activation checkpointing, f32 AdamW moments) on
           ``SyntheticDataset``. Gates: every parameter has a finite,
           non-zero gradient and moves in the first step (or, where bf16
           rounds AdamW's update away, its moments show the gradient
           arrived); the first loss is within 0.5 of ln(V) and the last is
           below it. Prints train_step_ms, tokens/s, mfu (active experts
           only), peak memory, the MoE aux of each step and a torch.profiler
           split of one step. Then one f32 step of each model at full width
           and 2 layers, card against CPU: loss, gradients, and AdamW on the
           same gradients; for olmoe first the routing of every layer, where
           each assignment that routes otherwise must be a near-tie on the
           CPU (and where one did, the tokens that route alike are also held,
           each its own loss). The
           path runs no hand kernel: ``repro`` trains through its plain
           routes, as the port does.
8. plan    the TAG planner: full-width qwen2-1.5b (8 x 512) and mamba2-130m
           (8 x 1024) training graphs traced on meta tensors (parameter
           bytes exact, matmul FLOPs within 2 % of the analytic count); bf16
           GEMMs timed with CUDA events and the utilization fitted against
           the H100 row of the cost model; then ``train --tag-search`` as a
           user runs it: a plan over ``h100_nodes()`` and 3 steps of
           full-width qwen2-1.5b, every kernel count at 0 just before it.
           Both full-width graphs are then searched as the launcher searches
           the reduced one: ``simplify``, ``partition`` into 24 groups and
           24 MCTS playouts over ``h100_nodes()``, each step timed.
9. dp      single-mesh data parallelism, every kernel count at 0 just before
           it: full-width qwen2-1.5b and mamba2-130m at 4 layers and
           olmoe-1b-7b at 2, f32, batch 8 x 128, the gradient of
           ``make_grad_step`` and one ``make_train_step`` under
           ``baseline_rules(make_host_mesh([cuda:0] * k))`` for k = 2 and 4,
           and at batch 6 over 4 (replicated), against one device's under
           the same rules (which pick the MoE group count), 1e-4, the MoE
           aux and router gradient included; then ``generate`` over
           ``[cuda:0] * 2`` (rows split and replicated) against one device's
           tokens.
10. pipeline both pipeline engines, every kernel count at 0 just before
           them. A gradient gate at full width: qwen2-1.5b at d_model 1536
           and 4 layers in f32, batch 8 x 128, all four schedules on
           ``[cuda:0, cuda:0]`` and AR, PS and SFB with 2-way stage data
           parallelism on ``[cuda:0] * 4`` under 1f1b and zb: the eager
           engine against the single-device gradient on the card, the
           compiled engine (its loops CUDA graphs, 1 and ``n_micro``
           microbatch bodies a graph) against the eager engine, with its
           ``peak_stash`` and event count. The same for olmoe-1b-7b at 4
           layers, 1f1b and zb with AR and 2 shards a stage, the eager engine
           against one device's mean over the row blocks the shards route
           alone, the compiled engine at unroll 1 against the eager engine.
           Then a user's run, once with each engine: ``run_pipeline`` on
           full-width, full-depth qwen2-1.5b in bf16 at batch 8 x 512,
           ``n_micro`` 4, 3 steps, with the 2-stage plan of
           ``plan_deployment`` and with a hand-built 2-stage plan; each
           step's time, events and stash come from the engine's telemetry
           records. Each pipeline is then built again and takes two train
           steps without per-event synchronization (the first captures the
           compiled engine's graphs), timed, and one profiled. On one card
           this checks the schedule and the gradients and measures the
           engines' overhead, not overlap. Each ``run_pipeline`` call also
           writes its last step's ``trace_executed.json`` (validated, the
           schedule's F/B/W events or the compiled engine's loops) and spools
           its events under its run id for the obs phase; the timed
           ``build_pipeline`` steps neither trace nor spool.
11. service the planner service, runtime feedback and the GNN policy, every
           kernel count at 0 just before them: ``launch/serve.py`` with
           ``--plan-topo h100 --observe`` on full-width qwen2-1.5b in bf16
           (batch 4, a prompt of 64, 32 tokens) on a fresh plan cache and
           telemetry log: a cold plan through ``PlannerService``, then the
           measured decode step fed back through ``observe`` (drift, kind)
           and logged; the same command again, served from the cache (no
           MCTS playout). Then the GNN on the card: ``train_policy`` for 3
           steps on reduced qwen2-1.5b and mamba2-130m graphs over
           ``h100_nodes()`` and a random topology, saved to and loaded from
           a ``PolicyRegistry``, a registry-guided search (and an unguided
           one, timed), and the priors on the card against the CPU. Last the
           H100 row's utilization fitted by ``fit_profile`` from the pipeline
           phase's engine telemetry (the hand-built plan's stages carry the
           full-width trace's FLOPs), and the full-width qwen2-1.5b plan
           simulated under the prior and under the fit, and searched again
           under the fit.
12. obs     the observability plane, every kernel count at 0 just before it:
           the plan phase's ``train --tag-search`` command again with
           ``--trace-dir``, ``--spool-dir``, ``--run-id obs-train``,
           ``--telemetry-dir`` and ``--xla-profile`` (the step runs 3 times,
           the profiled one once, the losses the unprofiled run's; the spans'
           trace validates; the torch.profiler trace holds CUDA kernels and
           ``n_collectives`` is printed: 0 on one card, where no NCCL kernel
           runs); ``PlannerService(device="cuda").serve_metrics`` over the
           phase's spool and telemetry (the pipeline runs and ``obs-train``),
           the hand-built pipeline's predicted timeline watched, every
           endpoint read, the CLI's ``metrics --url`` and ``health --url``
           against it; the CLI on the paper's zoo over ``h100`` (``plan
           --model bert_large`` cold then hit, ``verify --model resnet101``,
           ``verify --selftest``, ``trace --model transformer``, ``policy
           train`` on the card), each command's seconds and each graph's
           trace, simplify and partition seconds; ``dp_mlp_loss`` over
           ``[cuda:0] * 2`` and ``* 4``, AR, PS and SFB, f32, against one
           device, 1e-4.
13. kernels one JSON line with every kernel's launches, error and times.

The last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): the bound's peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tests/test_kernels.py: f32 summation order; bf16 one rounding of the output
KERNEL_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16: how far the kernel may be from the f32 plain version beyond half a
# bf16 step of the output (its own rounding). P V in f32 precision stays near
# 1e-6; P rounded to bf16 before P V reaches about 3e-3 at the slice's shapes.
ROUNDING_EXCESS_TOL = 1e-4
# tests/test_extensions.py:151, kernel route against the plain route
PARITY_ATOL = 2e-3
# tests/test_kernels.py:69-70 for y; the f32 state h relative to its size
SSD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
SSD_H_RTOL = 1e-4
# bf16: the kernel computes in f32 and rounds y once, so beyond half a bf16
# step it may differ from the f32 plain version only as the f32 case does
SSD_ROUNDING_EXCESS_TOL = 1e-4

# train phase: (batch, seq) a model, steps, loss chunk, and the launcher's
# learning rate. (At 2e-3 and 3e-3 qwen2-1.5b's loss rose to 15.3 and 15.8
# within the 6 steps, from 12.3.)
TRAIN_SHAPE = {"qwen2-1.5b": (8, 512), "mamba2-130m": (8, 1024), "olmoe-1b-7b": (8, 512)}
TRAIN_STEPS, TRAIN_LOSS_CHUNK, TRAIN_LR = 6, 128, 1e-3
TRAIN_LOSS_WINDOW = 0.5                  # first loss within this of ln(V)
# f32 train step, card against CPU, full width at 2 layers
TRAIN_PARITY_LAYERS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, TRAIN_PARITY_CHUNK = 2, 2, 128, 64
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-4, 1e-3, 1e-5
# plan phase: traced matmul FLOPs against the analytic count; bf16 GEMMs of
# (batch, GEMM_DIM) x (GEMM_DIM, GEMM_DIM) for the utilization fit
TRACE_FLOPS_RTOL = 0.02
GEMM_BATCHES, GEMM_DIM = (1024, 2048, 4096, 8192, 16384), 4096
TAG_SEARCH_ARGV = ["--arch", "qwen2-1.5b", "--tag-search", "--steps", "3", "--batch", "8",
                   "--seq", "512", "--loss-chunk", "128"]
SEARCH_GROUPS, SEARCH_PLAYOUTS = 24, 24
# what the search of the full graphs took before simplify was linear (PR 15's
# chip runs): qwen2-1.5b's simplify alone, and the call cut in mamba2-130m's
PR15_QWEN_SIMPLIFY_S, PR15_MAMBA_CUT_S = 59.28, 1500
# pipeline phase: the gradient gate (f32, full width, 4 layers so that
# interleaved has 4 virtual stages of one layer) and a user's run (bf16, full
# depth); the gate's error is max |a - b| / max |b| a leaf, the loss relative
PIPE_GATE_LAYERS, PIPE_GATE_BATCH, PIPE_GATE_SEQ, PIPE_GATE_TOL = 4, 8, 128, 1e-4
PIPE_RUN_BATCH, PIPE_RUN_SEQ, PIPE_RUN_MICRO, PIPE_RUN_STEPS = 8, 512, 4, 3
# dp phase: the gradient gate (f32, full width, 4 layers, TF32 off), each
# case (positions of [cuda:0] * k on the "data" axis, batch rows): split,
# split, replicated; then generate on [cuda:0] * 2, rows split and replicated
DP_SEQ, DP_TOL = 128, 1e-4
DP_CASES = ((2, 8), (4, 8), (4, 6))
DP_SERVE_ROWS, DP_SERVE_PROMPT, DP_SERVE_GEN = (4, 3), 16, 8

QWEN, MAMBA = "qwen2-1.5b", "mamba2-130m"
OLMOE, JAMBA, MUSICGEN, INTERNVL = ("olmoe-1b-7b", "jamba-v0.1-52b", "musicgen-large",
                                    "internvl2-26b")
SERVE_ARCHS = (QWEN, MAMBA, OLMOE, JAMBA, MUSICGEN, INTERNVL)
SERVE_PROMPT = {QWEN: 512, MAMBA: 1024, OLMOE: 512, JAMBA: 512, MUSICGEN: 512, INTERNVL: 512}
# jamba serves one period of 8 layers at full width: the whole model, 51.5 B
# parameters (103 GB in bf16), does not fit one card
SERVE_LAYERS = {JAMBA: 8}
SERVE_BATCH, SERVE_GEN = 4, 32
PARITY_BATCH, PARITY_PROMPT = 2, 256
# each kernel and the mixer whose layers launch it in a prefill
MIXER_KERNEL = {"A": "flash_attention", "M": "ssd_scan"}
KERNEL_SOURCES = ("flash_attention", "ssd_scan")
# the MoE train path (full width, 4 layers) and its card-against-CPU parity:
# an assignment that routes otherwise on the card must be a near-tie on the
# CPU, its two probabilities within this relative distance
MOE_TRAIN_LAYERS, ROUTE_TIE_RTOL = 4, 1e-6
# dp phase: depth a model (qwen2-1.5b and mamba2-130m 4, olmoe-1b-7b 2)
DP_ARCH_LAYERS = {QWEN: 4, MAMBA: 4, OLMOE: 2}
# service phase: serve --plan-topo h100 --observe (batch, prompt, tokens,
# playouts); the GNN's groups a reduced graph, train steps and playouts a
# step; GNN priors on the card against the CPU, f32
SERVICE_BATCH, SERVICE_PROMPT, SERVICE_GEN, SERVICE_PLAN_ITERS = 4, 64, 32, 20
SERVICE_GNN_GROUPS, SERVICE_GNN_STEPS, SERVICE_GNN_PLAYOUTS = 12, 3, 12
SERVICE_PRIOR_TOL = 1e-5
# obs phase: the profiled run's id, and how far its bf16 losses may lie from
# the plan phase's unprofiled run's (a second update in the profiled step
# would move the next loss by far more); playouts of the search whose spans
# the served spool shows; policy train on two zoo graphs (steps, playouts);
# the SFB MLP (widths, rows split over 2 and 4)
OBS_RUN_ID, OBS_LOSS_ATOL = "obs-train", 1e-3
OBS_PLAN_ITERS, OBS_POLICY_STEPS, OBS_POLICY_PLAYOUTS = 8, 3, 12
OBS_MLP_WIDTHS, OBS_MLP_ROWS = (1024, 4096, 1024), 64

BF16, F32 = torch.bfloat16, torch.float32
# (label, B, S, H, KV, hd, causal, window, dtype)
FLASH_CASES = [
    ("slice", 4, 512, 12, 2, 128, True, 0, BF16),
    ("slice", 4, 512, 12, 2, 128, True, 0, F32),
    ("slice_window128", 4, 512, 12, 2, 128, True, 128, BF16),
    ("slice_noncausal", 4, 512, 12, 2, 128, False, 0, BF16),
    *[(f"sweep_S{S}_hd{hd}", 2, S, 2, 2, hd, True, 0, dt)
      for S, hd in ((128, 64), (256, 64), (256, 32), (128, 128)) for dt in (F32, BF16)],
    *[(f"sweep_window{w}", 1, 256, 2, 2, 32, True, w, F32) for w in (32, 64, 100)],
    ("sweep_noncausal", 1, 128, 1, 1, 64, False, 0, F32),
    ("sweep_gqa", 2, 128, 4, 2, 32, True, 0, F32),
    ("ragged", 2, 100, 4, 2, 80, True, 0, BF16),
    # edges of the bf16 kernel's layout: G that its two query heads a block
    # do not divide, a sequence under one tile, the narrowest and widest hd
    # with a window
    *[(label, B, S, H, KV, hd, True, w, dt) for label, B, S, H, KV, hd, w in (
        ("heads_G5", 1, 192, 5, 1, 64, 0), ("heads_G3_S130", 2, 130, 6, 2, 48, 0),
        ("short_S40", 2, 40, 4, 2, 64, 0), ("window_hd16", 1, 256, 4, 2, 16, 48),
        ("window_hd128", 1, 320, 6, 2, 128, 100)) for dt in (BF16, F32)],
]
# (label, Bb, S, nh, hd, g, ds, chunk, dtype); "slice" is mamba2-130m's
# prefill at (4, 1024), with x, B and C strided views of one tensor as the
# model hands them over
SSD_CASES = [
    ("slice", 4, 1024, 24, 64, 1, 128, 128, BF16),
    ("slice", 4, 1024, 24, 64, 1, 128, 128, F32),
    *[(f"sweep_S{S}_hd{hd}", 2, S, nh, hd, nh, ds, chunk, dt)
      for S, nh, hd, ds, chunk in ((128, 2, 32, 16, 64), (256, 4, 64, 32, 128),
                                   (192, 1, 16, 8, 64)) for dt in (F32, BF16)],
    ("groups", 2, 256, 8, 32, 2, 64, 128, F32),
    ("padded", 1, 150, 3, 24, 1, 20, 50, BF16),
    # edges of the bf16 kernel's hd slices of 32: hd 24 and 48
    *[(f"hdslice{hd}", 2, 256, 4, hd, 2, 64, 128, dt) for hd in (24, 48) for dt in (BF16, F32)],
]
# the other families' prefills, bf16 as served: (label, B, S, H, KV, hd),
# causal; S counts a frontend's 256-token prefix; G = H / KV query heads a
# KV head (olmoe and musicgen MHA: 1)
FLASH_FAMILY = [(OLMOE, 4, 512, 16, 16, 128), (JAMBA, 4, 512, 32, 8, 128),
                (MUSICGEN, 4, 768, 32, 32, 64), (INTERNVL, 4, 768, 48, 8, 128)]
# jamba's Mamba layers: (label, Bb, S, nh, hd, g, ds, chunk), state 16
SSD_FAMILY = [(JAMBA, 4, 512, 128, 64, 1, 16, 128)]


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed ``replays`` times: the launches run back to back with
    no host time between them, whatever the caller's Python costs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up: builds, attributes, allocator
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def rounding_excess(o, ref) -> float:
    """Largest |o - ref| beyond half a bf16 step of ref: what a bf16 output
    carries besides its one rounding."""
    ref = ref.float()
    _, e = torch.frexp(ref)
    half_ulp = torch.where(ref == 0, 0.0, torch.exp2((e - 9).float()))  # step 2^(e-8)
    return ((o.float() - ref).abs() - half_ulp).max().item()


def plain_bf16_p(q, k, v, *, causal: bool, window: int):
    """The plain version with the softmax weights rounded to bf16 before P V:
    what the kernel would give if it rounded P. Only to size the check above."""
    from repro_torch.kernels.ref import NEG_INF
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).float()
    kh, vh = (t.transpose(1, 2).repeat_interleave(G, dim=1).float() for t in (k, v))
    s = qh @ kh.transpose(-1, -2) * q.shape[-1] ** -0.5
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None] if causal else torch.ones(S, S, dtype=torch.bool,
                                                                   device=q.device)
    if causal and window:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(BF16).float() @ vh) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).to(q.dtype)


def attended_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    if not causal:
        return S * S
    return sum(min(q + 1, window) if window else q + 1 for q in range(S))


# ------------------------------------------------------------------- phases

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
               f"count {torch.cuda.device_count()}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    return smi


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma<128, 3>``, ``ssd_chunk_scan<float>`` or
    ``ssd_chunk_scan_tc`` from an Itanium-mangled kernel name: the last
    component of its nested name and its template arguments."""
    s, i, name, args = mangled, 3 if mangled.startswith("_ZN") else 2, mangled, []
    while (m := re.match(r"\d+", s[i:])):
        n = int(m.group())
        name, i = s[i + m.end():i + m.end() + n], i + m.end() + n
    if s[i:i + 1] == "I":
        for a in re.finditer(r"Li(\d+)E|Lb([01])E|(f)|\d+(\w*?bfloat16)|(E)", s[i + 1:]):
            if a.group(5):
                break
            args.append(a.group(1) or {"0": "false", "1": "true"}.get(a.group(2)) or
                        ("float" if a.group(3) else "bf16"))
    return f"{name}<{', '.join(args)}>" if args else name


def _ptxas_lines(report: str):
    """One line per compiled kernel: registers and spills from -Xptxas -v."""
    name, spills, out = None, "", []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
    return out


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(build.build, KERNEL_SOURCES))
    log("build", f"{len(built)} sources in {time.perf_counter() - t0:.1f} s wall, in parallel")
    for b in built:
        log("build", f"{b.name}.cu " + (f"compiled in {b.seconds:.1f} s" if b.seconds
                                        else f"reused {b.path.name}"))
        for line in _ptxas_lines(b.report):
            log("build", line)
    sms = _sms()
    for dt in (BF16, F32):
        _, B, S, H, KV, hd, *_ = FLASH_CASES[0]
        log("build", f"flash_attention {str(dt)[6:]} at the serve shape: "
                     f"{_plan_text(fa.launch_plan(B, S, H, KV, hd, dt), sms)}")
        _, Bb, S, nh, hd, g, ds, chunk, _ = SSD_CASES[0]
        log("build", f"ssd_scan {str(dt)[6:]} at the serve shape: "
                     f"{_plan_text(ssd.launch_plan(Bb, nh, hd, ds, chunk, dt), sms)}")


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _plan_text(plan: dict, sms: int) -> str:
    extra = (f", {plan['heads_per_block']} query heads a block"
             if "heads_per_block" in plan else "")
    return (f"{plan['blocks']} blocks on {sms} SMs ({plan['blocks'] / sms:.2f} a SM), "
            f"{plan['threads']} threads and {plan['smem_bytes']} B of dynamic shared "
            f"memory a block{extra}")


def _rand(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


def kernel_flash(seed: int) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import ref_gqa_attention
    rng = np.random.default_rng(seed)
    failures, slice_err = [], None
    for label, B, S, H, KV, hd, causal, window, dt in FLASH_CASES:
        q, k, v = _rand(rng, (B, S, H, hd), dt), _rand(rng, (B, S, KV, hd), dt), \
            _rand(rng, (B, S, KV, hd), dt)
        o = fa.flash_attention(q, k, v, causal=causal, window=window)
        ref = ref_gqa_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        ok = o.dtype == dt and o.shape == q.shape and err <= KERNEL_ATOL[dt]
        excess = ""
        if dt == BF16:                        # against the plain version's f32 output
            ref32 = ref_gqa_attention(q.float(), k.float(), v.float(), causal=causal,
                                      window=window)
            x = rounding_excess(o, ref32)
            ok = ok and x <= ROUNDING_EXCESS_TOL
            excess = f", beyond half a bf16 step {x:.3g} (tol {ROUNDING_EXCESS_TOL:g})"
        log("kernel", f"flash_attention {label} B={B} S={S} H={H} KV={KV} hd={hd} "
                      f"causal={causal} window={window} {str(dt)[6:]}: max_abs_err {err:.3g} "
                      f"(tol {KERNEL_ATOL[dt]:g}){excess} {'ok' if ok else 'DISAGREES'}")
        if not ok:
            failures.append(label)
        if label == "slice" and dt == BF16:
            slice_err = err
            x_bf16_p = rounding_excess(plain_bf16_p(q, k, v, causal=causal, window=window),
                                       ref32)
            log("kernel", f"flash_attention slice bf16: with P rounded to bf16 before P V "
                          f"(plain emulation) the excess beyond half a bf16 step would be "
                          f"{x_bf16_p:.3g}")
    if failures:
        raise RuntimeError(f"flash_attention disagrees with its plain version: {failures}")

    # timing at the serve path's shapes and type
    _, B, S, H, KV, hd, causal, window, dt = FLASH_CASES[0]
    q, k, v = _rand(rng, (B, S, H, hd), dt), _rand(rng, (B, S, KV, hd), dt), \
        _rand(rng, (B, S, KV, hd), dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = (lib_out.transpose(1, 2).float() -
               ref_gqa_attention(q, k, v).float()).abs().max().item()
    lib_excess = rounding_excess(lib_out.transpose(1, 2),
                                 ref_gqa_attention(q.float(), k.float(), v.float()))
    kernel = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa: E731
                                                     enable_gqa=True)
    ms = graph_ms(kernel, 50)
    plain_ms = graph_ms(lambda: ref_gqa_attention(q, k, v, causal=True), 10)
    library_ms = graph_ms(library, 50)
    ms2 = graph_ms(kernel, 50)
    eager_ms, eager_library_ms = cuda_ms(kernel, 100), cuda_ms(library, 100)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * H * hd * attended_pairs(S, causal, window)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    bound_ms = max(t_bytes, t_ops)
    log("kernel", f"flash_attention timing B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal, "
                  f"device time from CUDA-graph replay: kernel {ms:.4f} ms and {ms2:.4f} ms (two "
                  f"runs), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
                  f"{library_ms:.4f} ms (max_abs_err {lib_err:.3g}, beyond half a bf16 step "
                  f"{lib_excess:.3g}); eager launches back to back (CUDA events, host time "
                  f"included): kernel {eager_ms:.4f} ms, SDPA {eager_library_ms:.4f} ms; "
                  f"bound {bound_ms * 1e3:.2f} us = max({nbytes / 1e6:.2f} MB at 3.35 TB/s, "
                  f"{flops / 1e9:.3f} GFLOP at 989 TFLOP/s); "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {bound_ms / ms:.2%} of the bound; "
                  f"{_plan_text(fa.launch_plan(B, S, H, KV, hd, dt), _sms())}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:24",
            "launches": None, "max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _ssd_inputs(rng, Bb, S, nh, hd, g, ds, dtype, *, strided: bool = False,
                model_dt: bool = False):
    """x, dt, A, B, C on the card, drawn as tests/test_kernels.py draws them,
    except that B and C have std min(1, (16/ds)^(1/4)): C Bᵀ then spreads as
    at ds 16 and |y| stays under 16, where the bf16 tolerance 1e-1 exceeds one
    bf16 step of y (0.0625). At unit std and ds 128 the plain bf16 route,
    which rounds C Bᵀ to bf16 as the JAX version does, moves y by a whole
    step of 0.125 beside the kernel's f32 C Bᵀ.
    ``strided``: x, B and C are views of one (Bb, S, conv_ch) tensor, as the
    model hands them over. ``model_dt``: unit std, and dt and A as the
    full-width model draws them (dt = softplus(N(0, 0.55^2)), A = -1), so
    that cum falls to about -96 within a chunk of 128, past f32's exp
    underflow."""
    bc_std = 1.0 if model_dt else min(1.0, (16 / ds) ** 0.25)
    if strided:
        xbc = torch.from_numpy(rng.standard_normal((Bb, S, nh * hd + 2 * g * ds))
                               .astype(np.float32))
        xbc[..., nh * hd:] *= bc_std
        xbc = xbc.to("cuda", dtype)
        x, B, C = torch.split(xbc, [nh * hd, g * ds, g * ds], dim=-1)
        x, B, C = x.reshape(Bb, S, nh, hd), B.reshape(Bb, S, g, ds), C.reshape(Bb, S, g, ds)
    else:
        x = _rand(rng, (Bb, S, nh, hd), dtype)
        B, C = ((_rand(rng, (Bb, S, g, ds), F32) * bc_std).to(dtype) for _ in range(2))
    if model_dt:
        dt = np.log1p(np.exp(0.55 * rng.standard_normal((Bb, S, nh))))
        A = -np.ones(nh)
    else:
        dt = rng.uniform(0.01, 0.2, (Bb, S, nh))
        A = -rng.uniform(0.5, 2.0, nh)
    return (x, torch.from_numpy(dt.astype(np.float32)).cuda(),
            torch.from_numpy(A.astype(np.float32)).cuda(), B, C)


def plain_ssd(x, dt, A, B, C, chunk):
    """The plain version as the wrapper's CPU route runs it: B and C
    repeated to every head, then ``ref_ssd_chunked``."""
    from repro_torch.kernels.ref import ref_ssd_chunked
    rep = x.shape[2] // B.shape[2]
    return ref_ssd_chunked(x, dt, A, B.repeat_interleave(rep, dim=2),
                           C.repeat_interleave(rep, dim=2), chunk)


def ssd_flops(Bb, S, nh, hd, ds, chunk) -> int:
    """What the chunked algorithm needs: C Bᵀ and its product with x·dt over
    the causal half of each Q x Q tile, C hᵀ and the state update in full."""
    Q = min(chunk, S)
    tri = Q * (Q + 1) // 2
    return Bb * nh * (S // Q) * (2 * tri * ds + 2 * tri * hd + 4 * Q * hd * ds)


def kernel_ssd(seed: int) -> dict:
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(seed + 2)
    failures, slice_err = [], None
    cases = [(*c, False) for c in SSD_CASES] + [
        ("slice_decay", 4, 1024, 24, 64, 1, 128, 128, dt, True) for dt in (F32, BF16)]
    for label, Bb, S, nh, hd, g, ds, chunk, dt, model_dt in cases:
        x, dtv, A, B, C = _ssd_inputs(rng, Bb, S, nh, hd, g, ds, dt,
                                      strided=label.startswith("slice"), model_dt=model_dt)
        y, h = ssd.ssd_scan(x, dtv, A, B, C, chunk=chunk)
        yr, hr = plain_ssd(x, dtv, A, B, C, chunk)
        torch.cuda.synchronize()
        err = (y.float() - yr.float()).abs().max().item()
        y_tol = SSD_ATOL[dt]
        if model_dt:    # y reaches about 1e2 here: the f32 tolerance relative to it
            y_tol *= max(1.0, yr.abs().max().item())
        h_err = (h - hr).abs().max().item()
        h_tol = SSD_H_RTOL * max(1.0, hr.abs().max().item())
        ok = (y.dtype == dt and y.shape == x.shape and h.shape == hr.shape
              and bool(torch.isfinite(y.float()).all()) and err <= y_tol and h_err <= h_tol)
        excess = ""
        if dt == BF16:                        # against the plain version's f32 output
            yr32, _ = plain_ssd(x.float(), dtv, A, B.float(), C.float(), chunk)
            xs = rounding_excess(y, yr32)
            xs_tol = SSD_ROUNDING_EXCESS_TOL * (y_tol / SSD_ATOL[dt])   # relative with model_dt
            ok = ok and xs <= xs_tol
            excess = f", beyond half a bf16 step {xs:.3g} (tol {xs_tol:.3g})"
        log("kernel", f"ssd_scan {label} Bb={Bb} S={S} nh={nh} hd={hd} g={g} ds={ds} "
                      f"chunk={chunk} {str(dt)[6:]}: y max_abs_err {err:.3g} (tol {y_tol:.3g}; "
                      f"max|y| {yr.float().abs().max().item():.3g}), h max_abs_err {h_err:.3g} "
                      f"(tol {h_tol:.3g}){excess} {'ok' if ok else 'DISAGREES'}")
        if not ok:
            failures.append(label)
        if label == "slice" and dt == BF16:
            slice_err = err
    if failures:
        raise RuntimeError(f"ssd_scan disagrees with its plain version: {failures}")

    # timing at the serve path's shapes, type and layout
    _, Bb, S, nh, hd, g, ds, chunk, dt = SSD_CASES[0]
    x, dtv, A, B, C = _ssd_inputs(rng, Bb, S, nh, hd, g, ds, dt, strided=True)
    kernel = lambda: ssd.ssd_scan(x, dtv, A, B, C, chunk=chunk)  # noqa: E731
    ms = graph_ms(kernel, 20)
    plain_ms = graph_ms(lambda: plain_ssd(x, dtv, A, B, C, chunk), 5)
    ms2 = graph_ms(kernel, 20)
    eager_ms = cuda_ms(kernel, 50)
    es = x.element_size()
    nbytes = (2 * x.numel() + B.numel() + C.numel()) * es + (dtv.numel() + A.numel()) * 4 \
        + Bb * nh * hd * ds * 4                                     # h out in f32
    flops = ssd_flops(Bb, S, nh, hd, ds, chunk)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dt] * 1e3
    bound_ms = max(t_bytes, t_ops)
    log("kernel", f"ssd_scan timing Bb={Bb} S={S} nh={nh} hd={hd} g={g} ds={ds} chunk={chunk} "
                  f"bf16, strided x/B/C, device time from CUDA-graph replay: kernel {ms:.4f} ms "
                  f"and {ms2:.4f} ms (two runs), plain {plain_ms:.4f} ms, no library call; eager "
                  f"launches back to back (CUDA events): kernel {eager_ms:.4f} ms; "
                  f"bound {bound_ms * 1e3:.2f} us = "
                  f"max({nbytes / 1e6:.2f} MB at 3.35 TB/s, {flops / 1e9:.3f} GFLOP at "
                  f"989 TFLOP/s); {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                  f"{bound_ms / ms:.2%} of the bound; "
                  f"{_plan_text(ssd.launch_plan(Bb, nh, hd, ds, chunk, dt), _sms())}")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:20",
            "launches": None, "max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _flash_check(fa, q, k, v) -> tuple:
    """The flash kernel on (q, k, v), causal, against its plain version:
    (max_abs_err, rounding excess in bf16 or None, ok)."""
    from repro_torch.kernels.ref import ref_gqa_attention
    dt = q.dtype
    o = fa.flash_attention(q, k, v, causal=True)
    err = (o.float() - ref_gqa_attention(q, k, v).float()).abs().max().item()
    ok = o.dtype == dt and o.shape == q.shape and err <= KERNEL_ATOL[dt]
    excess = None
    if dt == BF16:
        excess = rounding_excess(o, ref_gqa_attention(q.float(), k.float(), v.float()))
        ok = ok and excess <= ROUNDING_EXCESS_TOL
    return err, excess, ok


def kernel_family(seed: int, smi: str):
    """Both kernels at the shapes of the other families' prefills: each
    checked in f32 and bf16 against its plain version with the gates above,
    then timed in bf16 (``graph_ms``) beside its plain version, SDPA (flash)
    and the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ref_gqa_attention
    rng = np.random.default_rng(seed + 3)
    for label, B, S, H, KV, hd in FLASH_FAMILY:
        checks = []
        for dt in (F32, BF16):
            q, k, v = (_rand(rng, (B, S, h, hd), dt) for h in (H, KV, KV))
            err, excess, ok = _flash_check(fa, q, k, v)
            checks.append(f"{str(dt)[6:]} max_abs_err {err:.3g} (tol {KERNEL_ATOL[dt]:g})"
                          + ("" if excess is None else f", beyond half a bf16 step "
                             f"{excess:.3g} (tol {ROUNDING_EXCESS_TOL:g})")
                          + (" ok" if ok else " DISAGREES"))
            if not ok:
                log("kernel", f"flash_attention {label}: " + "; ".join(checks))
                raise RuntimeError(f"flash_attention disagrees with its plain version at "
                                   f"{label}'s shape")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True), 50)
        plain_ms = graph_ms(lambda: ref_gqa_attention(q, k, v, causal=True), 5)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 50)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4 * B * H * hd * attended_pairs(S, True, 0)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[BF16] * 1e3
        bound_ms = max(t_bytes, t_ops)
        log("kernel", f"flash_attention {label} B={B} S={S} H={H} KV={KV} hd={hd} causal: "
                      + "; ".join(checks) + f"; bf16 graph_ms kernel {ms:.4f}, plain "
                      f"{plain_ms:.4f}, scaled_dot_product_attention {library_ms:.4f} "
                      f"(kernel/SDPA {ms / library_ms:.3f}); bound {bound_ms * 1e3:.2f} us "
                      f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes / 1e6:.2f} MB, "
                      f"{flops / 1e9:.3f} GFLOP), {bound_ms / ms:.2%} of the bound; "
                      f"{_plan_text(fa.launch_plan(B, S, H, KV, hd, BF16), _sms())}; {smi}")
    for label, Bb, S, nh, hd, g, ds, chunk in SSD_FAMILY:
        checks = []
        for dt in (F32, BF16):
            x, dtv, A, B_, C = _ssd_inputs(rng, Bb, S, nh, hd, g, ds, dt, strided=True)
            y, h = ssd.ssd_scan(x, dtv, A, B_, C, chunk=chunk)
            yr, hr = plain_ssd(x, dtv, A, B_, C, chunk)
            err = (y.float() - yr.float()).abs().max().item()
            h_err = (h - hr).abs().max().item()
            h_tol = SSD_H_RTOL * max(1.0, hr.abs().max().item())
            ok = (y.dtype == dt and y.shape == x.shape and bool(torch.isfinite(y.float()).all())
                  and err <= SSD_ATOL[dt] and h_err <= h_tol)
            text = (f"{str(dt)[6:]} y max_abs_err {err:.3g} (tol {SSD_ATOL[dt]:g}), h "
                    f"{h_err:.3g} (tol {h_tol:.3g})")
            if dt == BF16:
                yr32, _ = plain_ssd(x.float(), dtv, A, B_.float(), C.float(), chunk)
                xs = rounding_excess(y, yr32)
                ok = ok and xs <= SSD_ROUNDING_EXCESS_TOL
                text += f", beyond half a bf16 step {xs:.3g} (tol {SSD_ROUNDING_EXCESS_TOL:g})"
            checks.append(text + (" ok" if ok else " DISAGREES"))
            if not ok:
                log("kernel", f"ssd_scan {label}: " + "; ".join(checks))
                raise RuntimeError(f"ssd_scan disagrees with its plain version at {label}'s "
                                   f"shape")
        ms = graph_ms(lambda: ssd.ssd_scan(x, dtv, A, B_, C, chunk=chunk), 20)
        plain_ms = graph_ms(lambda: plain_ssd(x, dtv, A, B_, C, chunk), 5)
        es = x.element_size()
        nbytes = (2 * x.numel() + B_.numel() + C.numel()) * es + (dtv.numel() + A.numel()) * 4 \
            + Bb * nh * hd * ds * 4
        flops = ssd_flops(Bb, S, nh, hd, ds, chunk)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[BF16] * 1e3
        bound_ms = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        log("kernel", f"ssd_scan {label} Bb={Bb} S={S} nh={nh} hd={hd} g={g} ds={ds} "
                      f"chunk={chunk}, strided x/B/C: " + "; ".join(checks)
                      + f"; bf16 graph_ms kernel {ms:.4f}, plain {plain_ms:.4f}, no library "
                      f"call; bound {bound_ms * 1e3:.2f} us ({by}: {nbytes / 1e6:.2f} MB, "
                      f"{flops / 1e9:.3f} GFLOP), "
                      f"{bound_ms / ms:.2%} of the bound; "
                      f"{_plan_text(ssd.launch_plan(Bb, nh, hd, ds, chunk, BF16), _sms())}; {smi}")


def phase_kernel(seed: int, smi: str) -> list:
    kernels = [kernel_flash(seed), kernel_ssd(seed)]
    kernel_family(seed, smi)
    return kernels


def reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    fa.flash_attention.launches = 0
    ssd.ssd_scan.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    return {"flash_attention": fa.flash_attention.launches, "ssd_scan": ssd.ssd_scan.launches}


def phase_serve(arch: str, seed: int) -> dict:
    """One serve path at full width, bf16: a prefill through the hand kernels,
    then ``generate``. Returns the kernel counts of the path and the model
    (config, parameters, prefill batch)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models.model import init_params
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = cfg.replace(num_layers=SERVE_LAYERS[arch])
    want = {MIXER_KERNEL[ch]: cfg.pattern.count(ch) * cfg.num_periods for ch in MIXER_KERNEL}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT[arch]))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    n_prefix = cfg.frontend_tokens if cfg.frontend != "none" else 0
    if n_prefix:                                  # the stubbed frontend's embeddings
        batch["prefix"] = torch.as_tensor(rng.standard_normal(
            (SERVE_BATCH, n_prefix, cfg.d_model)).astype(np.float32), device=dev)
    prefill = steps.make_prefill_step(cfg.replace(attn_impl="pallas"), None)
    mixers = []
    if "A" in cfg.pattern:
        mixers.append(f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}")
    if "M" in cfg.pattern:
        mixers.append(f"{cfg.ssm_nheads} SSM heads of {cfg.ssm_head_dim}, d_state "
                      f"{cfg.ssm_state}")
    if cfg.num_experts:
        mixers.append(f"{cfg.num_experts} experts top-{cfg.experts_per_token} of d_ff "
                      f"{cfg.d_ff} every {cfg.moe_every} layer(s), capacity factor "
                      f"{cfg.capacity_factor:g}")
    log("serve", f"{arch} full width: {cfg.num_layers} layers ({cfg.pattern} x "
                 f"{cfg.num_periods}), d_model {cfg.d_model}, {', '.join(mixers)}, vocab "
                 f"{cfg.vocab_size}, {n_params / 1e9:.3f} B parameters in {cfg.dtype}; prompts "
                 f"{tuple(prompts.shape)}"
                 + (f" behind a {n_prefix}-token {cfg.frontend} prefix" if n_prefix else ""))

    times = []
    for _ in range(6):                       # the first call loads the library and warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times[1:])

    # the main path, with every kernel count at 0 just before it
    resident = torch.cuda.memory_allocated()     # params and whatever earlier phases left
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    after_prefill = read_counts()
    stats: dict = {}
    out = serve.generate(cfg, params, prompts, SERVE_GEN, prefix=batch.get("prefix"),
                         stats=stats)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    if after_prefill != want:
        raise RuntimeError(f"prefill launched {after_prefill}, not once per layer of each "
                           f"kernel's mixer ({want})")
    if counts != after_prefill:
        raise RuntimeError(f"generate launched a kernel ({counts} after {after_prefill}): its "
                           f"prompt is stepped through decode")
    if tuple(logits.shape) != (SERVE_BATCH, 1, cfg.vocab_size) or \
            not torch.isfinite(logits.float()).all():
        raise RuntimeError(f"prefill logits are malformed: {tuple(logits.shape)}")
    if tuple(out.shape) != (SERVE_BATCH, SERVE_GEN) or \
            not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError(f"generate gave {tuple(out.shape)} or tokens out of range")
    agree = int((logits[:, -1].argmax(-1) == out[:, 0]).sum())
    decode_ms = stats["decode_s"] / stats["decode_steps"] * 1e3
    log("serve", f"{arch} prefill_ms {prefill_ms:.3f} (median of {len(times) - 1}: "
                 f"{', '.join(f'{t:.3f}' for t in times[1:])}); kernel launches in one prefill "
                 f"{after_prefill}")
    log("serve", f"{arch} generate: prompt stepped through decode in {stats['prefill_s']:.3f} s "
                 f"({prompts.size / stats['prefill_s']:.1f} tok/s), "
                 f"decode_ms_per_step {decode_ms:.3f}, "
                 f"{SERVE_BATCH * SERVE_GEN / stats['decode_s']:.1f} generated tok/s, "
                 f"max_memory_allocated {peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB "
                 f"allocated before the prefill); "
                 f"output {tuple(out.shape)}; sample {out[0, :8].tolist()}")
    if cfg.num_experts:
        expert_bytes = sum(t.numel() * t.element_size()
                           for n, t in _named_leaves(params) if ".ffn.w_" in n and
                           t.dim() == 4)
        log("serve", f"{arch} decode reads every expert's weights each step (every expert runs "
                     f"its C >= 4 slots): {expert_bytes / 1e9:.3f} GB, "
                     f"{expert_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms a step at 3.35 TB/s, "
                     f"against decode_ms_per_step {decode_ms:.3f}")
    log("serve", f"prefill argmax equals the first generated token in {agree} of "
                 f"{SERVE_BATCH} rows (reported, not gated: bf16 prefill and stepped decode "
                 f"round at different places)")
    log("serve", f"kernel launches on the {arch} path: {counts}")
    return counts, (cfg, params, batch)


GEMM_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "addmm", "aten::mm", "aten::bmm")


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "attention kernel"
    if "ssd_chunk_scan" in low:
        return "SSD kernel"
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    return "other"


def profile_window(fn, top: int = 8) -> dict:
    """Host wall time of ``fn`` (ms) without the profiler, then its profile:
    time in device kernels by group, and the kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernel_names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.key in kernel_names]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    groups: dict = {}
    for name, _, ms in rows:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": sum(r[1] for r in rows),
            "groups_ms": groups, "top": rows[:top]}


def phase_profile(cfg, params, batch, decode_steps: int = 8):
    from repro_torch.launch import steps
    from repro_torch.models.model import init_cache
    prefill = steps.make_prefill_step(cfg.replace(attn_impl="pallas"), None)
    serve_step = steps.make_serve_step(cfg, None)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if "prefix" in batch:
        S += batch["prefix"].shape[1]
    cache = init_cache(cfg, B, S + decode_steps, tokens.device)

    def decode_window():                          # the steps after a prompt of S positions
        cur = tokens[:, :1]
        for i in range(decode_steps):
            cur, _ = serve_step(params, cache, cur, S + i)

    for label, fn in ((f"{cfg.name} prefill ({B}, {S})", lambda: prefill(params, batch)),
                      (f"{cfg.name} decode x{decode_steps}", decode_window)):
        res = profile_window(fn)
        log("profile", f"{label}: wall {res['wall_ms']:.3f} ms without the profiler; kernel "
                       f"time {res['busy_ms']:.3f} ms in {res['launches']} launches, busy "
                       f"{res['busy_ms'] / res['wall_ms']:.1%} of the wall time; " + ", ".join(
                           f"{g} {ms:.3f} ms ({ms / res['busy_ms']:.1%})"
                           for g, ms in sorted(res["groups_ms"].items(), key=lambda kv: -kv[1])))
        for name, count, ms in res["top"]:
            log("profile", f"{label}:   {ms:9.3f} ms  x{count:<5d} {name[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parity_flash(seed: int):
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill_step
    dev = torch.device("cuda")
    cfg = get_config(QWEN).replace(dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT))
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    before = read_counts()["flash_attention"]
    kern = prefill_step(cfg.replace(attn_impl="pallas"), params, batch).float()
    launched = read_counts()["flash_attention"] - before
    plain = prefill_step(cfg.replace(attn_impl="jnp"), params, batch).float()
    torch.cuda.synchronize()
    diff = (kern - plain).abs().max().item()
    ok = launched == cfg.num_layers and bool(torch.isfinite(kern).all()) and diff <= PARITY_ATOL
    log("parity", f"{QWEN} full width f32, TF32 off, prompts {tokens.shape}: last-position "
                  f"logits through the kernel ({launched} launches) vs the plain chunked "
                  f"path: max_abs_diff {diff:.3g} (tol {PARITY_ATOL:g}; logits max "
                  f"{plain.abs().max().item():.3g}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("kernel-route prefill disagrees with the plain route")
    del params
    torch.cuda.empty_cache()


def parity_ssd(seed: int):
    """The kernel route on the card against the model's own scan
    (``attn_impl="jnp"``) on the CPU, from a copy of the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill_step
    dev = torch.device("cuda")
    cfg = get_config(MAMBA).replace(dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    tokens = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT)))
    before = read_counts()["ssd_scan"]
    kern = prefill_step(cfg.replace(attn_impl="pallas"), params,
                        {"tokens": tokens.to(dev)}).float().cpu()
    launched = read_counts()["ssd_scan"] - before
    t0 = time.perf_counter()
    plain = prefill_step(cfg, _to(params, "cpu"), {"tokens": tokens}).float()
    cpu_s = time.perf_counter() - t0
    diff = (kern - plain).abs().max().item()
    n_layers = cfg.pattern.count("M") * cfg.num_periods
    ok = launched == n_layers and bool(torch.isfinite(kern).all()) and diff <= PARITY_ATOL
    log("parity", f"{MAMBA} full width f32, TF32 off, prompts {tuple(tokens.shape)}: last-position "
                  f"logits through the SSD kernel on the card ({launched} launches) vs the plain "
                  f"chunked scan on the CPU ({cpu_s:.1f} s): max_abs_diff {diff:.3g} (tol "
                  f"{PARITY_ATOL:g}; logits max {plain.abs().max().item():.3g}) "
                  f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError("kernel-route prefill disagrees with the plain route")
    del params
    torch.cuda.empty_cache()


def _named_leaves(tree, prefix=""):
    """(name, leaf) pairs in ``optim.adam.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def train_flops_per_token(cfg, n_params: int, seq: int) -> float:
    """Model FLOPs of one trained token: 6 N (a forward and a backward pass
    over every weight in a matmul: N is the parameter count less the input
    embedding table when the head is untied, since a lookup is no matmul; a
    tied table is the head's matmul and counts once) plus 6 H hd S for each
    attention layer (Q Kᵀ and P V over the causal half of S keys, forward
    and backward). Recomputation under checkpointing is not counted, nor is
    the SSD scan's own arithmetic. In an MoE layer only the K experts a token
    is routed to count (N less (E - K) / E of the expert weights), not the
    capacity's empty or dropped slots, nor the router's softmax."""
    n = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    if cfg.num_experts:
        n_moe = sum(j % cfg.moe_every == cfg.moe_every - 1
                    for j in range(len(cfg.pattern))) * cfg.num_periods
        expert = n_moe * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
        n -= expert * (cfg.num_experts - cfg.experts_per_token) / cfg.num_experts
    n_attn = cfg.pattern.count("A") * cfg.num_periods
    return 6.0 * n + 6.0 * n_attn * cfg.num_heads * cfg.resolved_head_dim * seq


def _annotation_ms(prof, name: str) -> float:
    """Device time of the kernels launched inside ``record_function(name)``."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type.name == "CPU") / 1e3


def profile_train_step(run, wall_ms: float) -> str:
    """torch.profiler over one train step: kernel time by group. GEMM by
    kernel name; attention is its softmax (forward and backward; its two
    batched products count as GEMM); optimizer is every kernel launched
    inside the step's ``train/clip`` and ``train/optimizer`` ranges; the
    rest is elementwise and other. Idle = the step's wall time without the
    profiler less the kernel time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and not e.name.startswith("train/")]
    host = [e.name for e in prof.events() if e.device_type.name == "CPU"]
    replays = sum(n == "cudaGraphLaunch" for n in host)
    host_launches = sum(n.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for n in host)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    gemm = sum(e.time_range.elapsed_us() for e in kernels
               if _kernel_group(e.name) == "gemm") / 1e3
    softmax = sum(e.time_range.elapsed_us() for e in kernels if "softmax" in e.name.lower()) / 1e3
    opt_ms = _annotation_ms(prof, "train/optimizer") + _annotation_ms(prof, "train/clip")
    other = busy - gemm - softmax - opt_ms
    idle = max(wall_ms - busy, 0.0)
    parts = [("GEMM", gemm), ("attention softmax", softmax), ("optimizer and clip", opt_ms),
             ("elementwise and other", other)]
    return (f"wall {wall_ms:.3f} ms without the profiler; kernel time {busy:.3f} ms in "
            f"{len(kernels)} kernels on the device ({host_launches} launched from the host, "
            f"{replays} CUDA graph replays), busy {busy / wall_ms:.1%}; " + ", ".join(
                f"{n} {ms:.3f} ms ({ms / wall_ms:.1%})" for n, ms in parts) +
            f", idle {idle:.3f} ms ({idle / wall_ms:.1%})")


def _update_rounds_away(opt, p, mu, nu) -> bool:
    """Whether a parameter ``p`` that the first AdamW step left unchanged got
    a gradient all the same: its first moment is non-zero, and the f32 value
    AdamW computed from its moments rounds back to ``p`` in every element.
    (In bf16 an update under half a step is lost: a gain at 1.0 moves only
    by more than 2^-9, which lr 1e-3 never reaches.)"""
    c1, c2 = 1.0 - opt.b1, 1.0 - opt.b2          # bias corrections at step 1
    delta = (mu.float() / c1) / (torch.sqrt(nu.float() / c2) + opt.eps)
    if p.ndim >= 2:
        delta = delta + opt.weight_decay * p.float()
    target = p.float() - opt.lr * delta
    return bool(mu.abs().max() > 0) and torch.equal(target.to(p.dtype), p)


def phase_train(arch: str, seed: int, layers: int | None = None):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.steps import StepOptions, make_train_step
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import AdamW
    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    B, S = TRAIN_SHAPE[arch]
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = AdamW(lr=TRAIN_LR)
    opt_state = opt.init(params)
    options = StepOptions(loss_chunk=TRAIN_LOSS_CHUNK, remat_policy="full")
    step_fn = make_train_step(cfg, opt, None, options)
    ds = SyntheticDataset(cfg.vocab_size, S, B, seed=seed)
    t0 = time.perf_counter()
    batches = [ds.device_batch(i, dev) for i in range(TRAIN_STEPS + 1)]
    named = _named_leaves(params)
    n_params = sum(t.numel() for _, t in named)
    log("train", f"{arch} full width: {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters "
                 f"in {cfg.dtype}, AdamW lr {TRAIN_LR:g} with {opt.state_dtype} moments, batch "
                 f"{B} x {S}, loss_chunk {options.loss_chunk}, remat {options.remat_policy}; "
                 f"{TRAIN_STEPS + 1} batches made in {time.perf_counter() - t0:.1f} s")

    # gate 1a: every parameter gets a finite, non-zero gradient
    ps = [t.requires_grad_(True) for _, t in named]
    loss0, _ = loss_fn(cfg, params, batches[0], loss_chunk=options.loss_chunk,
                       remat_policy=options.remat_policy)
    grads = torch.autograd.grad(loss0, ps, allow_unused=True)
    missing = [n for (n, _), g in zip(named, grads) if g is None]
    bad = [n for (n, _), g in zip(named, grads)
           if g is not None and not (bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0))]
    del grads
    log("train", f"gradients of the first batch: {len(named) - len(missing) - len(bad)} of "
                 f"{len(named)} leaves finite and non-zero; missing {missing}, non-finite or "
                 f"zero {bad}")
    if missing or bad:
        raise RuntimeError(f"{arch}: parameters without a usable gradient: {missing + bad}")

    before = [t.detach().clone() for _, t in named]
    reset_counts()
    losses, gnorms, times, auxes = [], [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, i, batches[i])
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
        if i == 0:          # gate 1b: every parameter moved in the first step
            moments = zip(_named_leaves(opt_state["mu"]), _named_leaves(opt_state["nu"]))
            still, rounded = [], []
            for (n, t), b, ((_, mu), (_, nu)) in zip(named, before, moments):
                if torch.equal(t.detach(), b):
                    (rounded if _update_rounds_away(opt, b, mu, nu) else still).append(n)
            del before
            log("train", f"after the first step {len(named) - len(still) - len(rounded)} of "
                         f"{len(named)} leaves changed; unchanged with a non-zero first moment "
                         f"and an AdamW update under half a {cfg.dtype} step in every element "
                         f"{rounded}; unchanged otherwise {still}")
            if still:
                raise RuntimeError(f"{arch}: parameters unchanged by the first step: {still}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()

    step_ms = statistics.median(times[1:])
    tok_s = B * S / (step_ms / 1e3)
    mfu = train_flops_per_token(cfg, n_params, S) * B * S / (step_ms / 1e3) / PEAK_FLOPS[BF16]
    log("train", f"losses {', '.join(f'{x:.4f}' for x in losses)} (ln V = "
                 f"{np.log(cfg.vocab_size):.4f}; the gradient check's loss of the first batch "
                 f"{float(loss0.detach()):.4f}); grad norms "
                 f"{', '.join(f'{x:.3f}' for x in gnorms)}; MoE aux "
                 f"{', '.join(f'{x:.5f}' for x in auxes)}")
    log("train", f"train_step_ms {step_ms:.3f} (median of steps 2-{TRAIN_STEPS}: "
                 f"{', '.join(f'{t:.3f}' for t in times[1:])}; first step {times[0]:.3f}); "
                 f"tokens/s {tok_s:.1f}; mfu {mfu:.2%} (model FLOPs "
                 f"{train_flops_per_token(cfg, n_params, S) * B * S / 1e12:.3f} TFLOP a step = "
                 f"(6 N + 6 L_attn H hd S) x tokens, N without an untied input embedding"
                 f"{', the active experts only' if cfg.num_experts else ''}, "
                 f"against 989 TFLOP/s bf16 dense); "
                 f"max_memory_allocated {peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB "
                 f"allocated before the phase)")
    log("train", f"kernel launches on the train path: {counts} (none expected: no hand kernel "
                 f"has a backward, and the path trains through the model's own routes)")
    del loss0
    if any(counts.values()):
        raise RuntimeError(f"{arch}: the train path launched a forward-only kernel: {counts}")
    ln_v = float(np.log(cfg.vocab_size))
    if not all(np.isfinite(losses)) or abs(losses[0] - ln_v) > TRAIN_LOSS_WINDOW:
        raise RuntimeError(f"{arch}: first loss {losses[0]:.4f} is not within "
                           f"{TRAIN_LOSS_WINDOW} of ln V = {ln_v:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{arch}: loss did not fall: {losses}")

    i = TRAIN_STEPS
    log("train", f"{arch} profile of one step: " + profile_train_step(
        lambda: step_fn(params, opt_state, i, batches[i]), step_ms))
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return step_ms


def _routes(cfg, params, batch) -> list:
    """Every MoE layer's routing in one forward pass, in layer order, on the
    CPU: (chosen experts, kept, router probabilities). ``moe.route`` is
    wrapped for the pass to record what each layer routed."""
    from repro_torch.models import moe
    from repro_torch.models.model import forward
    got, orig = [], moe.route

    def record(*a, **kw):
        r = orig(*a, **kw)
        got.append((r.e_idx.cpu(), r.keep.cpu(), r.probs.detach().cpu()))
        return r

    moe.route = record
    try:
        with torch.no_grad():
            forward(cfg, params, batch, remat=False)
    finally:
        moe.route = orig
    return got


def _token_ce(cfg, params, batch):
    """Each token's cross-entropy (B, S), from one forward pass, on the CPU."""
    from repro_torch.models.model import forward
    with torch.no_grad():
        h, _, n_prefix = forward(cfg, params, batch, remat=False)
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        logits = (h[:, n_prefix:] @ w).float()
        return F.cross_entropy(logits.transpose(1, 2), batch["labels"].long(),
                               reduction="none").cpu()


def route_parity(cfg, params, batch_of) -> tuple:
    """The routing of every MoE layer on the card against the CPU, from the
    same parameters and batch (``batch_of(device)``). Returns (number of
    assignments whose expert differs, number whose kept slot alone differs,
    (B, S) mask of the tokens whose routes agree in every layer and in no
    earlier position of their row). Raises where a chosen expert differs
    without a near-tie on the CPU, or a kept slot differs in a layer and
    group where no choice did."""
    card = _routes(cfg, _to(params, "cuda"), batch_of("cuda"))
    cpu = _routes(cfg, _to(params, "cpu"), batch_of("cpu"))
    B, S = batch_of("cpu")["tokens"].shape
    n_prefix = cfg.frontend_tokens if cfg.frontend != "none" else 0
    agree = torch.ones(B * (n_prefix + S), dtype=torch.bool)
    flips = followers = 0
    for layer, ((e1, k1, _), (e0, k0, p0)) in enumerate(zip(card, cpu, strict=True)):
        diff_e = e1 != e0
        for g, t, k in diff_e.nonzero().tolist():
            a, b = p0[g, t, e1[g, t, k]].item(), p0[g, t, e0[g, t, k]].item()
            if abs(a - b) > ROUTE_TIE_RTOL * max(a, b):
                raise RuntimeError(f"layer {layer}, token {t}, slot {k}: the card chose expert "
                                   f"{e1[g, t, k].item()} ({a:.9g} on the CPU), the CPU "
                                   f"{e0[g, t, k].item()} ({b:.9g}): not a near-tie")
        diff_k = (k1 != k0) & ~diff_e
        for g in range(e1.shape[0]):
            if diff_k[g].any() and not diff_e[g].any():
                raise RuntimeError(f"layer {layer}, group {g}: kept slots differ where no "
                                   f"choice did")
        flips += int(diff_e.sum())
        followers += int(diff_k.sum())
        agree &= ~(diff_e | (k1 != k0)).any(-1).reshape(-1)
    agree = agree.reshape(B, n_prefix + S)[:, n_prefix:]
    return flips, followers, agree.int().cumprod(dim=1).bool()


def train_parity(arch: str, seed: int):
    """One f32 train step at full width and 2 layers on the card against the
    same step on the CPU, from the same parameters and batch: the loss and
    every gradient leaf. The updated parameters are gated on the same
    gradients (the card's, clipped and applied by AdamW on both devices):
    applied to each side's own gradients, AdamW's first step, lr x g / (|g|
    + eps), turns round-off of a gradient near eps = 1e-8 into a difference
    of up to lr, so the end-to-end comparison is reported, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.steps import StepOptions, make_train_step
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import AdamW, clip_by_global_norm, from_leaves, leaves
    cfg = get_config(arch).replace(dtype="float32", num_layers=TRAIN_PARITY_LAYERS)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    names = [n for n, _ in _named_leaves(params)]
    ds = SyntheticDataset(cfg.vocab_size, TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH, seed=seed + 1)
    opt = AdamW(lr=TRAIN_LR)
    options = StepOptions(loss_chunk=TRAIN_PARITY_CHUNK)
    step = make_train_step(cfg, opt, None, options)
    flips = 0
    if cfg.num_experts:
        flips, followers, agree = route_parity(cfg, params, lambda d: ds.device_batch(0, d))
        log("train", f"parity {arch} routing, card against CPU, {cfg.num_layers} layers of "
                     f"{cfg.num_experts} experts top-{cfg.experts_per_token}: {flips} "
                     f"assignments chose another expert (each a near-tie on the CPU, within "
                     f"{ROUTE_TIE_RTOL:g} relative), {followers} kept another slot after them; "
                     f"{int(agree.sum())} of {agree.numel()} tokens route alike")
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = _to(params, dev)
        batch = ds.device_batch(0, dev)
        ps = [t.requires_grad_(True) for t in leaves(p)]
        loss, _ = loss_fn(cfg, p, batch, loss_chunk=TRAIN_PARITY_CHUNK)
        grads = [g.cpu() for g in torch.autograd.grad(loss, ps)]
        p, _, m = step(p, opt.init(p), 0, batch)
        out[dev] = (float(m["loss"]), grads, [t.detach().cpu() for t in leaves(p)],
                    time.perf_counter() - t0)
    (lc, gc, pc, sc), (lr, gr, pr, sr) = out["cuda"], out["cpu"]
    same = {}
    for dev in ("cuda", "cpu"):            # AdamW on the card's gradients, on both devices
        p = _to(params, dev)
        g, _ = clip_by_global_norm(from_leaves(params, [t.to(dev) for t in gc]),
                                   options.clip_norm)
        p, _ = opt.update(p, opt.init(p), g, 0)
        same[dev] = [t.cpu() for t in leaves(p)]

    def rel(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    loss_err = abs(lc - lr) / abs(lr)
    g_err = {n: rel(a, b) for n, a, b in zip(names, gc, gr)}
    u_err = {n: rel(a, b) for n, a, b in zip(names, same["cuda"], same["cpu"])}
    p_err = {n: rel(a, b) for n, a, b in zip(names, pc, pr)}
    g_worst, u_worst, p_worst = (max(d, key=d.get) for d in (g_err, u_err, p_err))
    k = names.index(p_worst)
    at = ((pc[k] - pr[k]).abs().argmax().item())
    g_at = (gc[k].flatten()[at].item(), gr[k].flatten()[at].item())
    n_over = sum(int(((a - b).abs() > TRAIN_PARAM_TOL * max(1.0, b.abs().max().item())).sum())
                 for a, b in zip(pc, pr))
    ok = (loss_err <= TRAIN_LOSS_RTOL and all(bool(torch.isfinite(g).all()) for g in gc)
          and g_err[g_worst] <= TRAIN_GRAD_TOL and u_err[u_worst] <= TRAIN_PARAM_TOL)
    if flips:
        # on top of the whole loss and gradients: the tokens whose routes
        # agree, each its own loss
        ce = [_token_ce(cfg, _to(params, d), ds.device_batch(0, d)) for d in ("cuda", "cpu")]
        tok_err = ((ce[0] - ce[1]).abs() / ce[1].abs())[agree].max().item()
        ok = ok and tok_err <= TRAIN_LOSS_RTOL
        log("train", f"parity {arch}: routes flipped, so the gate also holds the "
                     f"{int(agree.sum())} tokens that route alike (and follow no other route in "
                     f"their row): each token's loss within {tok_err:.3g} relative (tol "
                     f"{TRAIN_LOSS_RTOL:g}) {'ok' if tok_err <= TRAIN_LOSS_RTOL else 'FAILED'}")
    log("train", f"parity {arch} full width, {TRAIN_PARITY_LAYERS} layers, f32, TF32 off, batch "
                 f"{TRAIN_PARITY_BATCH} x {TRAIN_PARITY_SEQ}, one step on the card ({sc:.1f} s) vs "
                 f"the CPU ({sr:.1f} s): loss {lc:.6f} vs {lr:.6f}, relative {loss_err:.3g} (tol "
                 f"{TRAIN_LOSS_RTOL:g}); worst gradient {g_worst} {g_err[g_worst]:.3g} x max(1, "
                 f"max|g|) (tol {TRAIN_GRAD_TOL:g}); AdamW on the same gradients: worst updated "
                 f"parameter {u_worst} {u_err[u_worst]:.3g} x max(1, max|p|) (tol "
                 f"{TRAIN_PARAM_TOL:g}) {'ok' if ok else 'FAILED'}")
    log("train", f"parity {arch}, not gated: each device's step on its own gradients, worst "
                 f"updated parameter {p_worst} {p_err[p_worst]:.3g} x max(1, max|p|), "
                 f"{n_over} elements beyond {TRAIN_PARAM_TOL:g}; at the worst element the "
                 f"gradients are {g_at[0]:.3g} (card) and {g_at[1]:.3g} (CPU), against AdamW's "
                 f"eps {opt.eps:g}")
    if not ok:
        raise RuntimeError(f"{arch}: the train step on the card disagrees with the CPU")
    torch.cuda.empty_cache()


def _meta_params(defs, dtype):
    """Parameters of a ParamDef tree as meta tensors: shapes, no memory."""
    if isinstance(defs, dict):
        return {k: _meta_params(v, dtype) for k, v in defs.items()}
    return torch.empty(defs.shape, dtype=dtype, device="meta")


def plain_route_matmul_flops(cfg, n_params: int, B: int, S: int) -> float:
    """What the model's plain routes multiply in one training step without
    recomputation: the model FLOPs of ``train_flops_per_token`` plus what the
    plain routes compute beyond them. Attention scores the full S x S square
    and masks it, another 6 H hd S a token a layer. The SSD scan runs four
    products a chunk (C Bᵀ and its product with x·dt over full Q x Q tiles,
    C hᵀ, the state update), forward and twice in the backward pass, less
    the three state products autograd skips: the gradient into the zero
    initial state and the last chunk's state update, which nothing reads."""
    total = train_flops_per_token(cfg, n_params, S) * B * S
    n_attn = cfg.pattern.count("A") * cfg.num_periods
    total += 6.0 * n_attn * cfg.num_heads * cfg.resolved_head_dim * S * B * S
    n_ssm = cfg.pattern.count("M") * cfg.num_periods
    if n_ssm:
        Q, nh, hd, ds = min(cfg.ssm_chunk, S), cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
        unit = 2.0 * B * Q * nh * hd * ds
        fwd = (S // Q) * (2.0 * B * nh * Q * Q * (ds + hd) + 2 * unit)
        total += n_ssm * (3 * fwd - 3 * unit)
    return total


def plan_trace(arch: str, smi: str):
    """Full-width training graph traced on meta tensors; gates on parameter
    bytes and matmul FLOPs. Returns the graph, unsimplified."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.torch_export import trace_training_graph
    from repro_torch.models.model import loss_fn, model_defs, torch_dtype
    cfg = dataclasses.replace(get_config(arch), attn_impl="jnp")
    B, S = TRAIN_SHAPE[arch]
    params = _meta_params(model_defs(cfg), torch_dtype(cfg))
    batch = {k: torch.empty((B, S), dtype=torch.int64, device="meta") for k in ("labels", "tokens")}
    leaves = [t for _, t in _named_leaves(params)]
    n_params = sum(t.numel() for t in leaves)
    want_bytes = sum(t.numel() * t.element_size() for t in leaves)
    t0 = time.perf_counter()
    g = trace_training_graph(lambda p, b: loss_fn(cfg, p, b, remat=False)[0], params, batch, arch)
    trace_s = time.perf_counter() - t0
    got_bytes = sum(n.param_bytes for n in g.nodes.values())
    mm = sum(n.flops for n in g.nodes.values() if n.op_type in ("mm", "bmm", "addmm", "baddbmm"))
    want_mm = plain_route_matmul_flops(cfg, n_params, B, S)
    model_flops = train_flops_per_token(cfg, n_params, S) * B * S
    splits, total = {}, g.total_flops()
    for n in g.nodes.values():
        splits[n.split.name] = splits.get(n.split.name, 0.0) + n.flops / total
    log("plan", f"{arch} full width, batch {B} x {S}, {cfg.dtype}: traced {len(g.nodes)} aten "
                f"ops in {trace_s:.2f} s; "
                f"parameter bytes {got_bytes:.0f} (model {want_bytes}); matmul FLOPs "
                f"{mm / 1e12:.4f} T against {want_mm / 1e12:.4f} T analytic (ratio "
                f"{mm / want_mm:.5f}; {mm / model_flops:.5f} of the model FLOPs alone); total "
                f"{g.total_flops() / 1e12:.4f} T; FLOP share by split "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(splits.items())) + f"; {smi}")
    if got_bytes != want_bytes:
        raise RuntimeError(f"{arch}: traced parameter bytes {got_bytes} != {want_bytes}")
    if abs(mm / want_mm - 1) > TRACE_FLOPS_RTOL:
        raise RuntimeError(f"{arch}: traced matmul FLOPs {mm:.4g} are not within "
                           f"{TRACE_FLOPS_RTOL:.0%} of the analytic {want_mm:.4g}")
    return g


def plan_search(arch: str, g, smi: str):
    """The search of a full-width graph, as the launcher searches the reduced
    one: ``simplify``, ``partition``, then MCTS with the SFB post-pass over
    ``h100_nodes()``, each step timed; the plan it lowers to. Returns the
    grouped graph and the search's result."""
    from repro_torch.core import tag as tag_mod
    from repro_torch.core.device import h100_nodes
    from repro_torch.core.graph import group_graph
    from repro_torch.core.partition import partition
    from repro_torch.core.plan import lower_strategy
    topo = h100_nodes()
    n0, e0 = len(g.nodes), len(g.edges)
    t0 = time.perf_counter()
    g.simplify()
    t1 = time.perf_counter()
    gg = group_graph(g, partition(g, SEARCH_GROUPS))
    t2 = time.perf_counter()
    result = tag_mod.optimize(None, None, None, topo, gg=gg, name=arch,
                              iterations=SEARCH_PLAYOUTS, n_groups=SEARCH_GROUPS)
    t3 = time.perf_counter()
    plan = lower_strategy(result.strategy, gg, topo)
    before = (f"PR 15: simplify alone {PR15_QWEN_SIMPLIFY_S} s" if arch == QWEN else
              f"PR 15: not done, the call was cut at {PR15_MAMBA_CUT_S} s inside simplify")
    log("plan", f"{arch} full-width search over {topo.name}: simplify {n0} nodes / {e0} edges "
                f"-> {len(g.nodes)} / {len(g.edges)} in {t1 - t0:.3f} s ({before}); partition "
                f"into {gg.n} groups {t2 - t1:.3f} s; MCTS {SEARCH_PLAYOUTS} playouts + SFB "
                f"{t3 - t2:.3f} s; plan {plan.summary['options']}, {plan.summary['n_stages']} "
                f"pipeline stages, simulated {result.time:.6g} s against DP-AllReduce "
                f"{result.baseline_time:.6g} s, speedup {result.speedup:.4f}; {smi}")
    if not (result.strategy.complete() and np.isfinite(result.time) and result.time > 0):
        raise RuntimeError(f"{arch}: the full-width search gave no complete, finite plan")
    return gg, result


def plan_gemm_profile(smi: str):
    """The profiler's bf16 GEMM line on the card, and the utilization it
    implies against the cost model's H100 peak (printed, not applied)."""
    from repro_torch.core.device import GPU_PEAKS
    from repro_torch.core.profiler import fit_utilization, profile_matmul_batches
    peak = GPU_PEAKS["H100"]["peak_flops"]
    t0 = time.perf_counter()
    line = profile_matmul_batches(GEMM_BATCHES, dim=GEMM_DIM, device=torch.device("cuda"))
    flops = [2.0 * b * GEMM_DIM * GEMM_DIM for b in GEMM_BATCHES]
    util = fit_utilization(flops, [line(b) for b in GEMM_BATCHES], peak)
    log("plan", f"bf16 GEMM ({'/'.join(map(str, GEMM_BATCHES))} x {GEMM_DIM}) x ({GEMM_DIM} x "
                f"{GEMM_DIM}), CUDA events, median of 5 after a warm-up: t = {line.a * 1e3:.5f} ms "
                f"+ {line.b * 1e9:.4f} ns x batch; at {GEMM_BATCHES[-1]} rows "
                f"{flops[-1] / line(GEMM_BATCHES[-1]) / 1e12:.1f} TFLOP/s; fitted utilization "
                f"{util} of {peak / 1e12:.0f} TFLOP/s (cost-model prior "
                f"{GPU_PEAKS['H100']['util']}, unchanged); {time.perf_counter() - t0:.1f} s; {smi}")
    if util is None or not 0 < util <= 1:
        raise RuntimeError(f"GEMM utilization fit gave {util}")


def plan_tag_search(smi: str):
    """``python -m repro_torch.launch.train`` with ``--tag-search`` on the
    card; the plan it made is kept by wrapping ``plan_deployment``."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    kept = {}
    plan_deployment = train_mod.plan_deployment

    def keep(*a, **kw):
        t0 = time.perf_counter()
        kept["result"], kept["plan"] = out = plan_deployment(*a, **kw)
        kept["s"] = time.perf_counter() - t0
        return out

    out = io.StringIO()
    train_mod.plan_deployment = keep
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            losses = train_mod.main(TAG_SEARCH_ARGV)
    finally:
        train_mod.plan_deployment = plan_deployment
        print(out.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    counts = read_counts()
    result, plan = kept["result"], kept["plan"]
    strat, gg = result.strategy, result.gg
    dups = sum(len(p.dup_op_types) for p in result.sfb_plans.values())
    saved = sum(p.saved_sync_bytes for p in result.sfb_plans.values())
    log("plan", f"--tag-search: trace and search {kept['s']:.2f} s of {wall:.1f} s; "
                f"{len(gg.base.nodes)} ops in {gg.n} groups; option mix "
                f"{plan.summary['options']}; {plan.summary['n_stages']} pipeline stages; SFB "
                f"duplications: {dups} ops in {len(result.sfb_plans)} groups, "
                f"{saved / 1e6:.3f} MB of gradient sync saved; simulated {result.time:.6g} s "
                f"against DP-AllReduce {result.baseline_time:.6g} s, speedup "
                f"{result.speedup:.4f}; kernel launches {counts}; {smi}")
    if len(strat.actions) != gg.n or not strat.complete():
        raise RuntimeError(f"the strategy covers {strat.n_decided} of {gg.n} groups")
    if not (np.isfinite(result.time) and result.time > 0
            and np.isfinite(result.speedup) and result.speedup > 0):
        raise RuntimeError(f"simulated time {result.time} / speedup {result.speedup}")
    if plan.stage_plan is not None and "WARNING: TAG pipeline fallback" not in out.getvalue():
        raise RuntimeError("the plan pipelines but the fallback line was not printed")
    if any(counts.values()):
        raise RuntimeError(f"the train path launched a forward-only kernel: {counts}")
    ln_v = float(np.log(get_config(QWEN).vocab_size))
    if not (len(losses) == 3 and all(np.isfinite(losses))
            and abs(losses[0] - ln_v) <= TRAIN_LOSS_WINDOW):
        raise RuntimeError(f"losses {losses}: not 3 finite losses, the first within "
                           f"{TRAIN_LOSS_WINDOW} of ln V = {ln_v:.4f}")
    torch.cuda.empty_cache()
    return losses


def phase_dp(seed: int, smi: str):
    """Single-mesh data parallelism on one card, ``[cuda:0] * k`` standing
    for k devices of the host mesh: the gradient of ``make_grad_step`` (what
    ``make_train_step`` runs before clipping and AdamW) under
    ``baseline_rules(make_host_mesh([cuda:0] * k))`` against one device's,
    and one ``make_train_step`` of each, loss and gradient norm; full-width
    qwen2-1.5b and mamba2-130m at 4 layers and olmoe-1b-7b at 2, f32. One
    device runs under the same rules, which pick the MoE group count (as
    ``repro``'s step on one device would), and the data-parallel step forms
    the aux loss with the whole batch's density. Then ``generate`` over
    ``[cuda:0] * 2`` against one device's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import init_params
    from repro_torch.optim.adam import AdamW, leaves
    from repro_torch.parallel.sharding import axis_rules
    dev = torch.device("cuda", 0)
    opt = AdamW(lr=TRAIN_LR)
    for arch, n_layers in DP_ARCH_LAYERS.items():
        cfg = get_config(arch).replace(dtype="float32", num_layers=n_layers)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        rng = np.random.default_rng(seed)
        rows_max = max(r for _, r in DP_CASES)
        full = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows_max, DP_SEQ)),
                                   device=dev) for k in ("tokens", "labels")}
        lines, worst = [], 0.0
        for n, rows in DP_CASES:
            batch = {k: v[:rows] for k, v in full.items()}
            rules = steps.baseline_rules(mesh_mod.make_host_mesh([dev] * n))
            t0 = time.perf_counter()
            with axis_rules(rules):
                l1, m1, g1 = steps.make_grad_step(cfg, None)(params, batch)
            ln, mn, gn = steps.make_grad_step(cfg, rules)(params, batch)
            torch.cuda.synchronize(dev)
            took = time.perf_counter() - t0
            g_err = max(_rel(a, b) for a, b in zip(leaves(gn), leaves(g1), strict=True))
            l_err = abs(float(ln) - float(l1)) / abs(float(l1))
            moe_text = ""
            if cfg.num_experts:
                a_err = abs(float(mn["aux"]) - float(m1["aux"])) / abs(float(m1["aux"]))
                r_err = max(_rel(a, b) for (n_, a), (_, b) in zip(
                    _named_leaves(gn), _named_leaves(g1), strict=True) if n_.endswith("router"))
                l_err = max(l_err, a_err)
                moe_text = (f", aux {float(mn['aux']):.6f} rel {a_err:.3g}, router gradient "
                            f"{r_err:.3g}")
            finite = all(bool(torch.isfinite(g).all()) for g in leaves(gn))
            del g1, gn
            m = {}
            for key, r in (("one", None), ("dp", rules)):
                p = _to(params, dev)
                with axis_rules(rules):
                    _, _, m[key] = steps.make_train_step(cfg, opt, r)(p, opt.init(p), 0, batch)
                del p
            sl_err = abs(float(m["dp"]["loss"]) - float(m["one"]["loss"])) / abs(
                float(m["one"]["loss"]))
            gn_err = abs(float(m["dp"]["grad_norm"]) - float(m["one"]["grad_norm"])) / float(
                m["one"]["grad_norm"])
            worst = max(worst, g_err, l_err, sl_err, gn_err)
            ok = finite and max(g_err, l_err, sl_err, gn_err) <= DP_TOL
            split = "split" if rows % n == 0 else "replicated"
            lines.append(f"[cuda:0] x {n}, batch {rows} x {DP_SEQ} ({split}): loss rel "
                         f"{l_err:.3g}{moe_text}, gradients max rel {g_err:.3g}; train step "
                         f"loss rel "
                         f"{sl_err:.3g}, grad_norm rel {gn_err:.3g}; {took:.3f} s "
                         f"{'ok' if ok else 'FAILED'}")
            if not ok:
                log("dp", f"{arch}: " + "; ".join(lines))
                raise RuntimeError(f"{arch} data parallel over {n}, batch {rows}: beyond "
                                   f"{DP_TOL:g} of one device")
        for t in leaves(params):
            t.requires_grad_(False)             # the one-device step set it in place
        log("dp", f"gradient gate, {arch} full width (d_model {cfg.d_model}), {cfg.num_layers} "
                  f"layers, {cfg.dtype}, TF32 off, make_grad_step and make_train_step under "
                  f"baseline_rules(make_host_mesh([cuda:0] * k)) against one device: "
                  + "; ".join(lines) + f"; worst {worst:.3g} (tol {DP_TOL:g}, max |a - b| / "
                  f"max |b| a leaf; loss and grad_norm relative); {smi}")
        rules = steps.baseline_rules(mesh_mod.make_host_mesh([dev] * 2))
        served = []
        for rows in DP_SERVE_ROWS:
            prompts = rng.integers(0, cfg.vocab_size, (rows, DP_SERVE_PROMPT))
            with axis_rules(rules):
                one = generate(cfg, params, prompts, DP_SERVE_GEN)
            stats: dict = {}
            two = generate(cfg, params, prompts, DP_SERVE_GEN, rules, stats=stats)
            same = two.shape == one.shape and torch.equal(two, one)
            served.append(f"{rows} prompts of {DP_SERVE_PROMPT}: {DP_SERVE_GEN} tokens each, "
                          f"{'equal' if same else 'DIFFERENT'} (decode "
                          f"{stats['decode_s'] / DP_SERVE_GEN * 1e3:.3f} ms a step)")
            if not same:
                raise RuntimeError(f"{arch}: generate over [cuda:0] * 2 gave other tokens "
                                   f"than one device: {two.tolist()} vs {one.tolist()}")
        log("dp", f"serve {arch}, {cfg.num_layers} layers, {cfg.dtype}: generate under "
                  f"baseline_rules(make_host_mesh([cuda:0] * 2)) against one device: "
                  + "; ".join(served) + f"; {smi}")
        del params, full
        torch.cuda.empty_cache()


def _two_stage_plan(sync="allreduce", n_devices=1, n_micro=4, flops=1e9):
    """Two equal 1f1b stages, as a hand-built plan, ``flops`` each (what the
    engine's telemetry attributes to a stage's events)."""
    from repro_torch.exec import StagePlan, StageSpec
    return StagePlan(
        stages=[StageSpec(i, i, [i], flops=flops, param_bytes=0, grad_bytes=0, out_bytes=1e5,
                          sync=sync, n_devices=n_devices, gpu_type="H100") for i in range(2)],
        placement=(0, 1), n_micro=n_micro, schedule="1f1b")


def _rel(a, b) -> float:
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def pipeline_gate(dev, seed: int, smi: str):
    """Both engines' loss and gradients, full-width qwen2-1.5b at 4 layers in
    f32: every schedule on 2 stages (interleaved: 2 x 2 virtual stages), and
    AR, PS and SFB with 2-way stage data parallelism under 1f1b and zb. The
    eager engine against the single-device gradient on the same device; the
    compiled engine (its loops CUDA graphs) against the eager engine, with 1
    and with ``n_micro`` microbatch bodies a graph."""
    from repro_torch.configs import get_config
    from repro_torch.exec import CompiledPipelineRunner, PipelineRunner, split_model
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import from_leaves, leaves
    cfg = get_config(QWEN).replace(dtype="float32", num_layers=PIPE_GATE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    shape = (PIPE_GATE_BATCH, PIPE_GATE_SEQ)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, shape), device=dev)
             for k in ("tokens", "labels")}
    ps = [t.clone().requires_grad_(True) for t in leaves(params)]
    t0 = time.perf_counter()
    loss, _ = loss_fn(cfg, from_leaves(params, ps), batch, remat=False)
    ref = from_leaves(params, [g.detach() for g in torch.autograd.grad(loss, ps)])
    ref_loss = float(loss.detach())
    del ps, loss
    torch.cuda.synchronize(dev)
    ref_s = time.perf_counter() - t0

    def cut(tree, lo, hi):
        if isinstance(tree, dict):
            return {k: cut(v, lo, hi) for k, v in tree.items()}
        return tree[lo:hi]

    cases = [(sched, "allreduce", 1, 4, 2 if sched == "interleaved" else 1)
             for sched in ("gpipe", "1f1b", "interleaved", "zb")]
    cases += [(sched, sync, 2, 2, 1)
              for sched in ("1f1b", "zb") for sync in ("allreduce", "ps", "sfb")]
    worst, scan_worst, lines, scan_lines = 0.0, 0.0, [], []
    for sched, sync, n, n_micro, V in cases:
        plan = _two_stage_plan(sync, n, n_micro)
        splits = plan.layer_splits(cfg.num_periods, n_chunks=V)
        sp, fns, keys, tied = split_model(cfg, params, 2 * V, splits=splits)
        kw = dict(schedule=sched, n_micro=n_micro, n_chunks=V, mb_keys=keys, tied_ref=tied)
        runner = PipelineRunner(fns, plan, [[dev] * n] * 2, **kw)
        t0 = time.perf_counter()
        grads, stats = runner.step(runner.place_params(sp), batch)
        torch.cuda.synchronize(dev)
        took = time.perf_counter() - t0
        want = []
        for u, (lo, hi) in enumerate(splits):
            w = {"blocks": cut(ref["blocks"], lo, hi)}
            if u == 0:
                w["embed"] = ref["embed"]
            if u == len(splits) - 1:
                w["final_norm"] = ref["final_norm"]
                if "head" in ref:
                    w["head"] = ref["head"]
            want.append(w)
        errs = [_rel(a, b) for g, w in zip(grads, want, strict=True)
                for a, b in zip(leaves(g), leaves(w), strict=True) if b.numel()]
        g_err, l_err = max(errs), abs(stats.loss - ref_loss) / abs(ref_loss)
        worst = max(worst, g_err, l_err)
        ok = g_err <= PIPE_GATE_TOL and l_err <= PIPE_GATE_TOL and all(
            bool(torch.isfinite(x).all()) for g in grads for x in leaves(g))
        name = f"{sched}{f' x{V}v' if V > 1 else ''}, {sync} x{n} a stage"
        lines.append(f"{name}: loss rel {l_err:.3g}, gradients max rel {g_err:.3g}, "
                     f"peak_stash {stats.peak_stash}, {took:.3f} s {'ok' if ok else 'FAILED'}")
        if not ok:
            log("pipeline", "; ".join(lines))
            raise RuntimeError(f"pipeline {name}: loss {l_err:.3g} or gradients {g_err:.3g} "
                               f"beyond {PIPE_GATE_TOL:g} of the single-device step")
        U = 2 * V
        for unroll in sorted({1, n_micro}):
            scan = CompiledPipelineRunner(fns, plan, [[dev] * n] * 2, unroll=unroll, **kw)
            t0 = time.perf_counter()
            sg, ss = scan.step(scan.place_params(sp), batch, record=True)
            torch.cuda.synchronize(dev)
            took = time.perf_counter() - t0
            s_err = max(_rel(a, b) for x, y in zip(sg, grads, strict=True)
                        for a, b in zip(leaves(x), leaves(y), strict=True) if b.numel())
            sl_err = abs(ss.loss - stats.loss) / abs(stats.loss)
            scan_worst = max(scan_worst, s_err, sl_err)
            n_events = (3 if sched == "zb" else 2) * U
            ok = (s_err <= PIPE_GATE_TOL and sl_err <= PIPE_GATE_TOL
                  and ss.peak_stash == U * n_micro and len(ss.events) == n_events
                  and all(e[2] == -1 for e in ss.events)
                  and all(bool(torch.isfinite(x).all()) for g in sg for x in leaves(g)))
            scan_lines.append(
                f"{name}, unroll {unroll}: loss rel {sl_err:.3g}, gradients max rel "
                f"{s_err:.3g}, peak_stash {ss.peak_stash} (U x n_micro {U * n_micro}), events "
                f"{len(ss.events)} (want {n_events}), graphs {len(scan._graphs)}, {took:.3f} s "
                f"with capture {'ok' if ok else 'FAILED'}")
            if not ok:
                log("pipeline", "scan gate: " + "; ".join(scan_lines))
                raise RuntimeError(f"compiled engine {name}, unroll {unroll}: loss {sl_err:.3g}, "
                                   f"gradients {s_err:.3g}, stash {ss.peak_stash} or events "
                                   f"{len(ss.events)} off the eager engine's")
            del sg, ss, scan
        del grads, stats, runner, sp
    log("pipeline", f"gradient gate, {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} layers, "
                    f"{cfg.dtype}, batch {PIPE_GATE_BATCH} x {PIPE_GATE_SEQ}, against one "
                    f"device's loss {ref_loss:.6f} ({ref_s:.3f} s): " + "; ".join(lines)
                    + f"; worst {worst:.3g} (tol {PIPE_GATE_TOL:g}, max |a - b| / max |b| a "
                      f"leaf; loss relative); {smi}")
    log("pipeline", "scan gradient gate, the compiled engine's loops as CUDA graphs against "
                    "the eager engine, same shapes: " + "; ".join(scan_lines)
                    + f"; worst {scan_worst:.3g} (tol {PIPE_GATE_TOL:g}); {smi}")
    torch.cuda.empty_cache()


def pipeline_gate_moe(dev, seed: int, smi: str):
    """Both engines on an MoE model: full-width olmoe-1b-7b at 4 layers in
    f32, batch 8 x 128, 1f1b and zb with AR and 2 shards a stage on
    ``[cuda:0] * 4``, ``n_micro`` 2. Each shard routes its rows of a
    microbatch as one group with its own aux loss, as ``repro``'s stages do,
    so the eager engine is held to one device's mean of ``loss_fn`` over
    those 4 row blocks; the compiled engine (unroll 1) to the eager engine."""
    from repro_torch.configs import get_config
    from repro_torch.exec import CompiledPipelineRunner, PipelineRunner, split_model
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import from_leaves, leaves
    cfg = get_config(OLMOE).replace(dtype="float32", num_layers=PIPE_GATE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (PIPE_GATE_BATCH, PIPE_GATE_SEQ)),
                                device=dev) for k in ("tokens", "labels")}
    n, n_micro = 2, 2
    blocks, rows = n * n_micro, PIPE_GATE_BATCH // (n * n_micro)
    ps = [t.clone().requires_grad_(True) for t in leaves(params)]
    loss = sum(loss_fn(cfg, from_leaves(params, ps),
                       {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()},
                       remat=False)[0] for i in range(blocks)) / blocks
    ref = from_leaves(params, [g.detach() for g in torch.autograd.grad(loss, ps)])
    ref_loss = float(loss.detach())
    del ps, loss
    lines, worst = [], 0.0
    for sched in ("1f1b", "zb"):
        plan = _two_stage_plan("allreduce", n, n_micro)
        splits = plan.layer_splits(cfg.num_periods)
        sp, fns, keys, tied = split_model(cfg, params, 2, splits=splits)
        kw = dict(schedule=sched, n_micro=n_micro, mb_keys=keys, tied_ref=tied)
        runner = PipelineRunner(fns, plan, [[dev] * n] * 2, **kw)
        t0 = time.perf_counter()
        grads, stats = runner.step(runner.place_params(sp), batch)
        torch.cuda.synchronize(dev)
        took = time.perf_counter() - t0
        errs = {}
        for u, (g, (lo, hi)) in enumerate(zip(grads, splits, strict=True)):
            for name, a in _named_leaves(g):
                b = _leaf(ref, name, lo, hi)
                if b.numel():
                    errs[f"{u}.{name}"] = _rel(a, b)
        g_err, l_err = max(errs.values()), abs(stats.loss - ref_loss) / abs(ref_loss)
        r_err = max(v for k, v in errs.items() if k.endswith("router"))
        scan = CompiledPipelineRunner(fns, plan, [[dev] * n] * 2, unroll=1, **kw)
        sg, ss = scan.step(scan.place_params(sp), batch, record=True)
        torch.cuda.synchronize(dev)
        s_err = max(_rel(a, b) for x, y in zip(sg, grads, strict=True)
                    for a, b in zip(leaves(x), leaves(y), strict=True) if b.numel())
        sl_err = abs(ss.loss - stats.loss) / abs(stats.loss)
        n_events = (3 if sched == "zb" else 2) * 2
        worst = max(worst, g_err, l_err, s_err, sl_err)
        ok = (max(g_err, l_err, s_err, sl_err) <= PIPE_GATE_TOL and ss.peak_stash == 2 * n_micro
              and len(ss.events) == n_events and all(
                  bool(torch.isfinite(x).all()) for gg in (grads, sg) for g in gg
                  for x in leaves(g)))
        lines.append(f"{sched}, allreduce x{n} a stage: eager loss rel {l_err:.3g}, gradients "
                     f"max rel {g_err:.3g} (router {r_err:.3g}), peak_stash {stats.peak_stash}, "
                     f"{took:.3f} s; scan (unroll 1) against eager: loss rel {sl_err:.3g}, "
                     f"gradients {s_err:.3g}, peak_stash {ss.peak_stash}, events "
                     f"{len(ss.events)}, graphs {len(scan._graphs)} {'ok' if ok else 'FAILED'}")
        del grads, stats, runner, scan, sg, ss, sp
        if not ok:
            log("pipeline", "MoE gate: " + "; ".join(lines))
            raise RuntimeError(f"pipeline {sched} on {OLMOE}: beyond {PIPE_GATE_TOL:g} of one "
                               f"device's row blocks or of the eager engine")
    log("pipeline", f"MoE gradient gate, {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} "
                    f"layers of {cfg.num_experts} experts top-{cfg.experts_per_token}, "
                    f"{cfg.dtype}, batch {PIPE_GATE_BATCH} x {PIPE_GATE_SEQ}, n_micro {n_micro}, "
                    f"against one device's mean loss over the {blocks} row blocks the shards "
                    f"route ({ref_loss:.6f}): " + "; ".join(lines) + f"; worst {worst:.3g} (tol "
                    f"{PIPE_GATE_TOL:g}); {smi}")
    del params, ref
    torch.cuda.empty_cache()


def _leaf(tree, name: str, lo: int, hi: int):
    """Leaf ``name`` (dotted) of ``tree``; a ``blocks`` leaf cut to periods
    [lo, hi)."""
    for k in name.split("."):
        tree = tree[k]
    return tree[lo:hi] if name.startswith("blocks.") else tree


def pipeline_run(dev, seed: int, train_step_ms: float | None, smi: str, searched: bool = True,
                 stage_flops: float = 1e9, telemetry: list | None = None,
                 obs_root: Path | None = None) -> dict:
    """``run_pipeline`` as a user runs it, full-width, full-depth qwen2-1.5b
    in bf16, 3 steps, once with each engine: with ``searched``, the 2-stage
    plan of ``plan_deployment`` (or a hand-built one where that plan has
    fewer than 2 stages) on ``[dev, dev]``, or ``[dev] * 4`` where a stage
    syncs by SFB; otherwise a hand-built 2-stage 1f1b plan, equal halves, on
    ``[dev, dev]``, the engine without stage data parallelism. The engine's
    ``StepRecord``s in the telemetry directory give each step's time,
    events and stash (every event, or loop, synchronized to time it). Then
    the same pipeline, built afresh by ``build_pipeline``, takes two more
    steps without per-event synchronization, both timed (the first captures
    the compiled engine's graphs), then one more under torch.profiler.

    A hand-built plan gives each stage ``stage_flops``; where ``telemetry``
    is a list, the StepRecords of a hand-built plan's runs are appended to it
    (the service phase fits the H100 utilization from them).

    With ``obs_root``, each ``run_pipeline`` call also gets ``trace_dir``,
    ``spool_dir`` (``obs_root / "spool"``) and a run id, its
    ``trace_executed.json`` must validate with the schedule's events (eager)
    or loops (scan), and its StepRecords are appended to the telemetry log
    ``obs_root / "telemetry"`` that the obs phase serves. The timed steps of
    ``build_pipeline`` run without either. Returns ``{engine: (run id, plan,
    schedule)}``."""
    import argparse
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime.telemetry import TELEMETRY_FILE
    cfg = get_config(QWEN)
    sp, source = None, "hand-built, 2 equal stages"
    if searched:
        t0 = time.perf_counter()
        result, plan = train_mod.plan_deployment(QWEN, dev, n_micro=PIPE_RUN_MICRO)
        sp = plan.stage_plan
        source = (f"plan_deployment's ({0 if sp is None else sp.n_stages} stages, searched in "
                  f"{time.perf_counter() - t0:.2f} s, speedup {result.speedup:.4f})")
    hand_built = sp is None or sp.n_stages < 2
    if hand_built:
        sp = _two_stage_plan(n_micro=PIPE_RUN_MICRO, flops=stage_flops)
        source += ", fewer than 2 stages: a hand-built 2-stage plan" if searched else ""
    # SFB needs two participants (the verifier's TAG302): a plan with an SFB
    # stage gets two shards a stage, all on the one card
    per_stage = 2 if any(st.sync == "sfb" for st in sp.stages) else 1
    devices = [dev] * (per_stage * sp.n_stages)
    ln_v = float(np.log(cfg.vocab_size))
    single = "not measured" if train_step_ms is None else f"{train_step_ms:.3f} ms"
    free, runs = {}, {}
    for engine in ("eager", "scan"):
        run_id = f"pipe-{engine}-{'searched' if searched else 'hand'}"
        trace_dir = None if obs_root is None else obs_root / run_id
        args = argparse.Namespace(
            arch=QWEN, batch=PIPE_RUN_BATCH, seq=PIPE_RUN_SEQ, lr=TRAIN_LR, seed=seed,
            steps=PIPE_RUN_STEPS, log_every=1, ckpt_dir="", ckpt_every=0, resume=False,
            pipeline="auto", n_micro=PIPE_RUN_MICRO, n_chunks=2, telemetry_dir="",
            engine=engine, scan_unroll=1, run_id=run_id,
            trace_dir="" if trace_dir is None else str(trace_dir),
            spool_dir="" if obs_root is None else str(obs_root / "spool"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with tempfile.TemporaryDirectory() as telem:
            args.telemetry_dir = telem            # the engine records every step
            t0 = time.perf_counter()
            losses = train_mod.run_pipeline(args, cfg, sp, devices)
            wall = time.perf_counter() - t0
            lines = (Path(telem) / TELEMETRY_FILE).read_text().splitlines()
        recs = [json.loads(line) for line in lines]
        if hand_built and telemetry is not None:
            from repro_torch.runtime.telemetry import StepRecord
            telemetry.extend(StepRecord.from_dict(r) for r in recs)
        if obs_root is not None:
            runs[engine] = (run_id, sp, sp.schedule if args.pipeline == "auto" else args.pipeline)
            obs_pipeline_trace(trace_dir, engine, sp, recs, obs_root, smi)
        peak = torch.cuda.max_memory_allocated(dev)
        times = [r["wall_time"] * 1e3 for r in recs]
        last = recs[-1]["meta"]
        per = {}
        for e in last["events"]:
            per.setdefault((e["stage"], e["kind"]), []).append((e["finish"] - e["start"]) * 1e3)
        events = ", ".join(f"stage {s} {k} {len(v)} x {statistics.mean(v):.3f} ms (sum "
                           f"{sum(v):.3f})" for (s, k), v in sorted(per.items()))
        log("pipeline", f"run_pipeline --engine {engine}, {cfg.name}, {cfg.num_layers} layers, "
                        f"d_model {cfg.d_model}, {cfg.dtype}, batch {PIPE_RUN_BATCH} x "
                        f"{PIPE_RUN_SEQ}, n_micro {PIPE_RUN_MICRO}, schedule {sp.schedule}, stages "
                        f"{sp.n_stages} on {[str(d) for d in devices]}, sync "
                        f"{[s.sync for s in sp.stages]}, layers "
                        f"{sp.layer_splits(cfg.num_periods)}; plan {source}; "
                        f"losses {', '.join(f'{x:.4f}' for x in losses)} (ln V {ln_v:.4f}); "
                        f"engine ms a step (runner.step, every event or loop synchronized to "
                        f"time it; the scan engine's first step captures its graphs) "
                        f"{', '.join(f'{t:.3f}' for t in times)}; single-device train_step_ms "
                        f"at the same batch {single} (loss_chunk {TRAIN_LOSS_CHUNK}, full "
                        f"checkpointing); peak_stash {last['peak_stash']}; max_memory_allocated "
                        f"{peak / 2**30:.3f} GiB; {wall:.1f} s in all; events of the last step: "
                        f"{events}; {smi}")
        if not (len(losses) == len(recs) == PIPE_RUN_STEPS and all(np.isfinite(losses))
                and abs(losses[0] - ln_v) <= TRAIN_LOSS_WINDOW):
            raise RuntimeError(f"pipeline losses {losses}: not {PIPE_RUN_STEPS} finite losses, "
                               f"the first within {TRAIN_LOSS_WINDOW} of ln V = {ln_v:.4f}")
        # the whole train step (engine, clip, AdamW) without per-event
        # synchronization, then where its time goes; no trace, no spool
        args.telemetry_dir = args.trace_dir = args.spool_dir = ""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        run = train_mod.build_pipeline(args, cfg, sp, devices)
        batch = run.dataset.device_batch(0, "cpu")
        state = [run.params_list, run.opt_state_list]

        def step():
            state[0], state[1], _ = run.step_fn(state[0], state[1], 0, batch)

        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        free[engine] = ms[1]
        prof = profile_train_step(step, ms[1])
        peak = torch.cuda.max_memory_allocated(dev)
        log("pipeline", f"{source}, --engine {engine}: first train step {ms[0]:.3f} ms"
                        f"{' (captures the graphs)' if engine == 'scan' else ''}; "
                        f"pipeline_step_ms {ms[1]:.3f} (a train step without per-event "
                        f"synchronization); peak memory {peak / 2**30:.3f} GiB; profile of one "
                        f"such step: {prof}; {smi}")
        del run, state
        torch.cuda.empty_cache()
    log("pipeline", f"{source}: pipeline_step_ms eager {free['eager']:.3f}, scan "
                    f"{free['scan']:.3f} ({free['eager'] / free['scan']:.3f}x); single-device "
                    f"train_step_ms {single}; {smi}")
    return runs


def _serve_planned(argv: list) -> tuple:
    """``launch/serve.py::main`` as a user runs it, keeping what its
    ``plan_deployment`` returned and timing it; its output is printed and
    returned."""
    import contextlib
    import io
    from repro_torch.launch import serve as serve_mod
    kept = {}
    plan_deployment = serve_mod.plan_deployment

    def keep(*a, **kw):
        t0 = time.perf_counter()
        kept["resp"], kept["svc"], kept["gg"], kept["topo"] = out = plan_deployment(*a, **kw)
        kept["s"] = time.perf_counter() - t0
        return out

    out = io.StringIO()
    serve_mod.plan_deployment = keep
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            serve_mod.main(argv)
    finally:
        serve_mod.plan_deployment = plan_deployment
        print(out.getvalue(), end="", flush=True)
    kept["wall"] = time.perf_counter() - t0
    return kept, out.getvalue()


def _plan_seconds(svc, source: str) -> float:
    """``plan_graph``'s own seconds (no trace) from the service's metrics."""
    series = svc.stats()["metrics"]["planner_plan_seconds"]["series"]
    return series[f'{{source="{source}"}}']["sum"]


def _reduced_grouped(arch: str, n_groups: int):
    """The reduced config's training graph traced on meta tensors, as the
    serve launcher traces its plan (batch 4 x 32), grouped."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import tag as tag_mod
    from repro_torch.models.model import abstract_params, input_specs, loss_fn
    cfg = get_reduced(arch)
    specs = input_specs(cfg, InputShape("plan_4x32", 32, 4, "train"))
    return tag_mod.build_grouped(lambda p, b: loss_fn(cfg, p, b, remat=False)[0],
                                 abstract_params(cfg), specs, arch, n_groups)


def service_serve(seed: int, root: Path, smi: str):
    """Steps 1 and 2: ``serve --plan-topo h100 --observe`` at full width on
    a fresh plan cache and telemetry log, then the same command again."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.telemetry import MeasurementStore
    cache, telem = root / "plans", root / "telemetry"
    argv = ["--arch", QWEN, "--batch", str(SERVICE_BATCH), "--prompt-len", str(SERVICE_PROMPT),
            "--gen", str(SERVICE_GEN), "--seed", str(seed), "--plan-topo", "h100", "--observe",
            "--plan-iters", str(SERVICE_PLAN_ITERS), "--plan-cache", str(cache),
            "--telemetry-dir", str(telem)]
    cfg = get_config(QWEN)
    runs = []
    for k in range(2):
        kept, out = _serve_planned(argv)
        resp, svc = kept["resp"], kept["svc"]
        obs = re.search(r"^observe\[h100\] step=([\d.]+)s kind=(\w+)(?: drift=([\d.]+))?", out, re.M)
        if obs is None:
            raise RuntimeError(f"serve run {k + 1} printed no observe[...] line")
        step_s, kind, drift = float(obs.group(1)), obs.group(2), obs.group(3)
        logged = [r for r in MeasurementStore(str(telem)).records(graph_fp=resp.graph_fp,
                                                                    topo_fp=resp.topo_fp)]
        st = svc.stats()
        log("service", f"serve --plan-topo h100 --observe, run {k + 1}: {cfg.name} full width "
                       f"({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype}), batch "
                       f"{SERVICE_BATCH}, prompt {SERVICE_PROMPT}, {SERVICE_GEN} tokens; plan "
                       f"source={resp.source}, {resp.iterations_run} MCTS playouts, "
                       f"{kept['gg'].n} groups of {len(kept['gg'].base.nodes)} ops; "
                       f"plan_deployment {kept['s']:.3f} s (trace, group and plan_graph), "
                       f"plan_graph {_plan_seconds(svc, resp.source):.4f} s; simulated "
                       f"{resp.time:.6g} s, speedup {resp.speedup:.4f}; observed decode step "
                       f"{step_s:.4f} s, kind={kind}, drift={drift}; replans {st['replans']}, "
                       f"observations {st['observations']}, telemetry records of the plan "
                       f"{len(logged)}; {kept['wall']:.1f} s in all; {smi}")
        runs.append((resp, kind, logged))
        if not (np.isfinite(resp.time) and resp.time > 0 and resp.speedup > 0):
            raise RuntimeError(f"run {k + 1}: simulated time {resp.time}, speedup {resp.speedup}")
        if kind not in ("replanned", "ok") or st["observations"] != 1:
            raise RuntimeError(f"run {k + 1}: observe gave kind={kind}, {st['observations']} "
                               f"observations")
        if len(logged) != k + 1 or abs(logged[-1].wall_time - step_s) > 5e-5:
            raise RuntimeError(f"run {k + 1}: the telemetry log holds {len(logged)} records of "
                               f"the plan, not the observation of each run")
    (first, _, _), (second, _, _) = runs
    if first.source != "cold" or first.iterations_run != SERVICE_PLAN_ITERS:
        raise RuntimeError(f"first run: source={first.source}, {first.iterations_run} playouts")
    if second.source != "hit" or second.iterations_run != 0:
        raise RuntimeError(f"second run on the same cache: source={second.source}, "
                           f"{second.iterations_run} playouts (a cache hit runs none)")


def service_gnn(seed: int, root: Path, smi: str):
    """Step 3: the GNN policy on the card: 3 train steps, the registry,
    a guided search, and priors on the card against the CPU."""
    from repro_torch.core import trainer as trainer_mod
    from repro_torch.core.device import h100_nodes, random_topology
    from repro_torch.core.features import featurize
    from repro_torch.core.hetgnn import params_from_numpy, policy_probs
    from repro_torch.core.strategy import Strategy, candidate_actions
    from repro_torch.service import PlannerService, PolicyRegistry
    from repro_torch.service.fingerprint import fingerprint_grouped_cached, structural_features
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    graphs = [_reduced_grouped(arch, SERVICE_GNN_GROUPS) for arch in (QWEN, MAMBA)]
    topos = [h100_nodes(), random_topology(np.random.default_rng(seed))]
    trace_s = time.perf_counter() - t0
    state = trainer_mod.init_trainer(seed=seed)
    if state.params["enc_op"].device.type != "cuda":
        raise RuntimeError("init_trainer did not put the GNN on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer_mod.train_policy(state, graphs, steps=SERVICE_GNN_STEPS,
                             mcts_iters=SERVICE_GNN_PLAYOUTS, seed=seed, topologies=topos)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log("service", f"GNN train_policy on the card: {SERVICE_GNN_STEPS} steps, "
                   f"{SERVICE_GNN_PLAYOUTS} playouts each, over reduced {QWEN} and {MAMBA} "
                   f"({[g.n for g in graphs]} groups, traced in {trace_s:.2f} s) on {topos[0].name} "
                   f"and a random topology of {topos[1].m} groups; losses "
                   f"{[round(x, 6) for x in state.losses]}; {train_s:.2f} s; {smi}")
    if not state.losses or not all(np.isfinite(state.losses)):
        raise RuntimeError(f"GNN training losses {state.losses}: none, or not all finite")
    gg = graphs[0]
    reg = PolicyRegistry(str(root / "gnn" / "policies"))
    reg.save("chip", state.cfg, state.params, corpus=[fingerprint_grouped_cached(gg)],
             corpus_features=[structural_features(gg)], meta={"steps": SERVICE_GNN_STEPS})
    rec, params = reg.load("chip")
    if rec.gnn_config() != state.cfg or any(
            not np.array_equal(params[k], state.params[k].cpu().numpy()) for k in params):
        raise RuntimeError("the registry did not give back the saved parameters")
    topo = h100_nodes()
    timed = {}
    for label, svc in (("guided", PlannerService(cache_dir=str(root / "gnn"))),
                       ("unguided", PlannerService(use_registry=False))):
        t0 = time.perf_counter()
        resp = svc.plan_graph(gg, topo, iterations=SERVICE_PLAN_ITERS, seed=seed)
        timed[label] = (time.perf_counter() - t0, resp, svc.stats())
    secs, resp, st = timed["guided"]
    log("service", f"PlannerService search of reduced {QWEN} over {topo.name}, "
                   f"{SERVICE_PLAN_ITERS} playouts: guided by the registry's '{resp.policy}' "
                   f"{secs:.3f} s (speedup {resp.speedup:.4f}, policy_guided "
                   f"{st['policy_guided']}), unguided {timed['unguided'][0]:.3f} s (speedup "
                   f"{timed['unguided'][1].speedup:.4f}); {smi}")
    if resp.policy != "chip" or st["policy_guided"] < 1:
        raise RuntimeError(f"the search was not guided: policy={resp.policy}, stats {st}")
    het = featurize(gg, topo, Strategy.empty(gg.n), None, 0)
    actions = candidate_actions(topo, has_grad=True)
    worst = 0.0
    for gid in (0, gg.n // 2, gg.n - 1):
        on_card = policy_probs(state.cfg, params_from_numpy(params, dev), het, gid, actions)
        on_cpu = policy_probs(state.cfg, params_from_numpy(params, "cpu"), het, gid, actions)
        worst = max(worst, float((on_card.cpu() - on_cpu).abs().max()))
    log("service", f"GNN priors on the card against the CPU, the same parameters, 3 groups x "
                   f"{len(actions)} actions: max |diff| {worst:.3e} (tolerance "
                   f"{SERVICE_PRIOR_TOL:g})")
    if not worst <= SERVICE_PRIOR_TOL:
        raise RuntimeError(f"priors on the card differ from the CPU's by {worst}")


def service_calibration(records: list, qwen_gg, qwen_plan, smi: str):
    """Step 4: the H100 row's utilization fitted from the pipeline phase's
    engine telemetry, and the full-width qwen2-1.5b plan under the prior
    and under the fit."""
    from repro_torch.core import tag as tag_mod
    from repro_torch.core.device import GPU_PEAKS, h100_nodes
    from repro_torch.runtime.calibration import fit_profile
    topo = h100_nodes()
    samples = [c for r in records for c in r.compute
               if c.get("gpu_type") == "H100" and c.get("flops", 0) > 0 and c.get("time", 0) > 0]
    profile = fit_profile(records, topo)
    util = profile.util.get("H100")
    by_engine = {}
    for r in records:
        by_engine.setdefault(r.meta.get("engine"), []).append(r)
    per_engine = {e: fit_profile(rs, topo).util.get("H100") for e, rs in sorted(by_engine.items())}
    prior = GPU_PEAKS["H100"]["util"]
    if util is None or not 0 < util <= 1:
        raise RuntimeError(f"the H100 fit gave {util} from {len(samples)} samples")
    calib = profile.apply(topo)
    t_prior = tag_mod.strategy_step_time(qwen_gg, qwen_plan.strategy, topo, sfb=True)
    t_fit = tag_mod.strategy_step_time(qwen_gg, qwen_plan.strategy, calib, sfb=True)
    t0 = time.perf_counter()
    refit = tag_mod.optimize(None, None, None, calib, gg=qwen_gg, iterations=SEARCH_PLAYOUTS,
                             n_groups=SEARCH_GROUPS)
    search_s = time.perf_counter() - t0
    same = refit.strategy.canonical_json() == qwen_plan.strategy.canonical_json()
    log("service", f"H100 calibration from the pipeline phase's engine telemetry (hand-built "
                   f"2-stage plan, each stage {qwen_gg.base.total_flops() / 2:.6g} FLOPs of the "
                   f"full-width trace): {len(records)} records, {len(samples)} compute samples; "
                   f"fitted utilization {util:.6f} against the row's prior {prior} and the bf16 "
                   f"GEMM fit of 0.82-0.85 (PR 15); by engine {per_engine}; by event kind "
                   f"{ {k: round(v, 6) for k, v in profile.util_by_op.items()} }; full-width "
                   f"{QWEN} plan over {topo.name} simulated {t_prior:.6g} s under the prior, "
                   f"{t_fit:.6g} s under the fit; searched again under the fit "
                   f"({search_s:.2f} s): simulated {refit.time:.6g} s, speedup "
                   f"{refit.speedup:.4f}, plan {'unchanged' if same else 'changed'}; {smi}")
    if not (np.isfinite(t_fit) and t_fit > 0 and refit.strategy.complete()):
        raise RuntimeError(f"the calibrated model gave {t_fit} / an incomplete plan")


def phase_service(seed: int, records: list, qwen_gg, qwen_plan, smi: str):
    """The planner service on the card: serve --plan-topo h100 --observe
    twice on one cache, the GNN policy, the H100 calibration."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        service_serve(seed, root, smi)
        service_gnn(seed, root, smi)
    service_calibration(records, qwen_gg, qwen_plan, smi)


# ------------------------------------------------------------------- obs

def obs_pipeline_trace(trace_dir: Path, engine: str, sp, recs: list, obs_root: Path, smi: str):
    """Step 2 of the obs phase, inside the pipeline phase's ``run_pipeline``
    calls: ``trace_executed.json`` validates and holds the last step's F/B/W
    events (eager: the schedule's; scan: ``2U`` or ``3U`` loops); the
    engine's records join the served telemetry log."""
    from repro_torch.exec.schedule import flatten_schedule, make_schedule
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.runtime.telemetry import MeasurementStore, StepRecord
    path = trace_dir / "trace_executed.json"
    doc = validate_chrome_trace(json.loads(path.read_text()))
    kinds = [e["name"][0] for e in doc["traceEvents"] if e["ph"] == "X"]
    events = flatten_schedule(make_schedule(sp.schedule, sp.n_stages, sp.n_micro), sp.n_stages,
                              sp.n_micro)
    has_w = any(e.kind == "W" for e in events)
    want = len(events) if engine == "eager" else (3 if has_w else 2) * sp.n_stages
    store = MeasurementStore(str(obs_root / "telemetry"))
    for r in recs:
        store.append(StepRecord.from_dict(r))
    shards = sorted(p.name for p in (obs_root / "spool").glob(f"{trace_dir.name}--*"))
    log("obs", f"{trace_dir.name}: trace_executed.json valid, {len(kinds)} events (F "
               f"{kinds.count('F')}, B {kinds.count('B')}, W {kinds.count('W')}; the "
               f"{'schedule' if engine == 'eager' else 'loops'}: {want}), "
               f"{path.stat().st_size} B; spool shards {shards}; {len(recs)} records to the "
               f"served telemetry; {smi}")
    if len(kinds) != want or set(kinds) - {"F", "B", "W"}:
        raise RuntimeError(f"{trace_dir.name}: {len(kinds)} traced events {set(kinds)}, "
                           f"want {want} F/B/W")
    if len(shards) != 1:
        raise RuntimeError(f"{trace_dir.name}: spool shards {shards}, want one")


def _stdout_of(fn, *a, echo: bool = True):
    """``fn(*a)`` with its standard output captured (and printed, with
    ``echo``); returns (its result, the output)."""
    import contextlib
    import io
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = fn(*a)
    finally:
        if echo:
            print(out.getvalue(), end="", flush=True)
    return res, out.getvalue()


def obs_train(root: Path, ref_losses: list, smi: str):
    """Step 1: the plan phase's ``train --tag-search`` command (full-width
    qwen2-1.5b, bf16, 8 x 512, single device after the plan's fallback,
    3 steps) again with ``--trace-dir``, ``--spool-dir``, ``--run-id``,
    ``--telemetry-dir`` and ``--xla-profile``: the train step runs 3 times
    (the profiled step once), the losses are the plan phase's unprofiled
    run's, ``trace_spans.json`` validates, the torch.profiler trace holds
    CUDA kernels, the spool shard one span a step."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.runtime.telemetry import MeasurementStore
    trace_dir, spool = root / "train-trace", root / "spool"
    argv = TAG_SEARCH_ARGV + ["--trace-dir", str(trace_dir), "--spool-dir", str(spool),
                              "--run-id", OBS_RUN_ID, "--telemetry-dir", str(root / "telemetry"),
                              "--xla-profile"]
    make, calls = steps_mod.make_train_step, []

    def counting(*a, **kw):
        step = make(*a, **kw)

        def run(*args, **kwargs):
            calls.append(1)
            return step(*args, **kwargs)
        return run

    steps_mod.make_train_step = counting
    reset_counts()
    t0 = time.perf_counter()
    try:
        losses, out = _stdout_of(train_mod.main, argv)
    finally:
        steps_mod.make_train_step = make
    wall = time.perf_counter() - t0
    counts = read_counts()
    line = next(ln for ln in out.splitlines() if ln.startswith("xla-profile: "))
    meta = json.loads(line[len("xla-profile: "):line.index(" (")])
    spans = validate_chrome_trace(json.loads((trace_dir / "trace_spans.json").read_text()))
    n_spans = sum(e["ph"] == "X" for e in spans["traceEvents"])
    prof = json.loads(Path(meta["trace_file"]).read_text())["traceEvents"]
    kernels = [e for e in prof if e.get("cat") == "kernel"]
    recs = [r for r in MeasurementStore(str(root / "telemetry")).records()
            if r.meta.get("run_id") == OBS_RUN_ID]
    shard = [json.loads(ln) for p in spool.glob(f"{OBS_RUN_ID}--train-*")
             for ln in p.read_text().splitlines()]
    steps = [r["name"] for r in shard if r["type"] == "span" and r["cat"] == "train"]
    diff = max(abs(a - b) for a, b in zip(losses, ref_losses))
    log("obs", f"train --tag-search with --trace-dir --spool-dir --run-id {OBS_RUN_ID} "
               f"--telemetry-dir --xla-profile: {QWEN} full width, batch 8 x 512, 3 steps, "
               f"{wall:.1f} s; train step called {len(calls)} times; losses "
               f"{', '.join(f'{x:.4f}' for x in losses)} against the unprofiled run's "
               f"{', '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| {diff:.3e}, tolerance "
               f"{OBS_LOSS_ATOL:g}); profiler {meta['profiler']}, n_collectives "
               f"{meta.get('n_collectives')} (one card: no NCCL kernel), "
               f"{len(kernels)} CUDA kernel events of {len(prof)} in "
               f"{Path(meta['trace_file']).stat().st_size / 1e6:.1f} MB; step ms "
               f"{', '.join(f'{r.wall_time * 1e3:.3f}' for r in recs)} (step 1 profiled); "
               f"trace_spans.json {n_spans} spans; spool {steps}; kernel launches {counts}; "
               f"{smi}")
    if len(calls) != 3 or not diff <= OBS_LOSS_ATOL:
        raise RuntimeError(f"the profiled run called the step {len(calls)} times; losses "
                           f"{losses} against {ref_losses}")
    if meta["profiler"] != "ok" or not kernels or n_spans == 0:
        raise RuntimeError(f"profile {meta}, {len(kernels)} kernel events, {n_spans} spans")
    if len(recs) != 3 or steps != ["step 0", "step 1", "step 2"] or any(counts.values()):
        raise RuntimeError(f"{len(recs)} telemetry records, spool spans {steps}, launches "
                           f"{counts}")


def obs_serve(root: Path, watch: tuple, smi: str):
    """Step 3: ``PlannerService(device="cuda").serve_metrics`` on 127.0.0.1,
    port 0, over the phase's spool and telemetry, after a search of the
    reduced qwen2-1.5b graph with the tracer on (its spans join the spool
    at a scrape), the hand-built pipeline's predicted timeline watched under
    its run id; every endpoint read, and the CLI's ``metrics --url`` and
    ``health --url`` against the same server."""
    import urllib.request
    from repro_torch.core.device import h100_nodes
    from repro_torch.exec.schedule import make_schedule, simulate_schedule
    from repro_torch.obs import (
        Tracer, parse_prometheus_text, set_tracer, validate_chrome_trace)
    from repro_torch.service import PlannerService
    from repro_torch.service import cli as cli_mod
    run_id, sp, schedule = watch
    topo = h100_nodes()
    tl = simulate_schedule(sp, topo, make_schedule(schedule, sp.n_stages, sp.n_micro))
    svc = PlannerService(cache_dir=str(root / "plans"), telemetry_dir=str(root / "telemetry"),
                         device="cuda")
    old = set_tracer(Tracer(enabled=True))
    server = None
    try:
        gg = _reduced_grouped(QWEN, SERVICE_GNN_GROUPS)
        resp = svc.plan_graph(gg, topo, iterations=OBS_PLAN_ITERS, seed=0)
        # the SLO: the watched pipeline's predicted step, 5 % over
        server = svc.serve_metrics(host="127.0.0.1", port=0, spool_dir=str(root / "spool"),
                                   run_id=OBS_RUN_ID, slo_s=tl.makespan * 1.05)
        server.health.watch(run_id, timeline=tl)
        timed = {}

        def get(path):
            t0 = time.perf_counter()
            with urllib.request.urlopen(server.url + path, timeout=60) as r:
                body = r.read().decode()
            timed[path] = (time.perf_counter() - t0) * 1e3
            return body

        fams = parse_prometheus_text(get("/metrics"))
        healthz = json.loads(get("/healthz"))
        plans = json.loads(get("/plans"))
        verify = json.loads(get(f"/plans/{resp.graph_fp}/verify"))
        runs = [r["run_id"] for r in json.loads(get("/runs"))["runs"]]
        health = {r: json.loads(get(f"/runs/{r}/health")) for r in runs}
        alerts = json.loads(get("/alerts"))
        doc = validate_chrome_trace(json.loads(get(f"/traces/{OBS_RUN_ID}")))
        procs = sorted({e["args"]["name"] for e in doc["traceEvents"]
                        if e["ph"] == "M" and e["name"] == "process_name"})
        rc_m, prom = _stdout_of(cli_mod.main, ["metrics", "--url", server.url], echo=False)
        parse_prometheus_text(prom)
        rc_h, h_out = _stdout_of(cli_mod.main, ["health", "--url", server.url], echo=False)
        cli_health = json.loads(h_out)
        watched = health.get(run_id, {})
        log("obs", f"serve_metrics at {server.url}: {len(fams)} metric families; healthz "
                   f"{healthz['status']}; {plans['store_size']} plan, verify "
                   f"{[m['verify'] for m in verify['matches']]}; runs {runs}; {run_id} mode "
                   f"{watched.get('mode')}, step_ratio {watched.get('step_ratio')}, dominant "
                   f"{watched.get('dominant')}; predicted step {tl.makespan * 1e3:.3f} ms; alerts "
                   f"{[(a['run_id'], a['rule'], a['state']) for a in alerts['alerts']]}; "
                   f"/traces/{OBS_RUN_ID} {sum(e['ph'] == 'X' for e in doc['traceEvents'])} "
                   f"spans from {procs}; ms a request "
                   f"{ {k: round(v, 3) for k, v in timed.items()} }; CLI metrics --url rc {rc_m}, "
                   f"health --url rc {rc_h} ({len(cli_health['health'])} runs); {smi}")
        if OBS_RUN_ID not in runs or run_id not in runs or watched.get("mode") != "predicted":
            raise RuntimeError(f"/runs {runs}, {run_id} health {watched}")
        if {p.split(" ")[0] for p in procs} != {"train", "planner"}:
            raise RuntimeError(f"/traces/{OBS_RUN_ID} holds the shards of {procs}")
        if rc_m or rc_h or sorted(cli_health["health"]) != sorted(runs):
            raise RuntimeError(f"CLI metrics rc {rc_m}, health rc {rc_h}")
    finally:
        if server is not None:
            server.stop()
        set_tracer(old)


def obs_cli(root: Path, smi: str):
    """Step 4: the service CLI on the zoo's graphs at the paper's sizes over
    ``h100``: ``plan --model bert_large`` cold, then a hit; ``verify --model
    resnet101`` and ``verify --selftest``; ``trace --model transformer``
    (four schedules, predicted against replayed); ``policy train`` on
    bert_small and vgg19, on the card. Each command's seconds and each
    graph's trace, simplify and partition seconds."""
    from repro_torch.core.graph import CompGraph
    from repro_torch.service import cli as cli_mod
    cache = str(root / "cli-plans")
    cmds = [("plan bert_large", ["plan", "--model", "bert_large", "--topo", "h100",
                                 "--cache-dir", cache]),
            ("plan bert_large", ["plan", "--model", "bert_large", "--topo", "h100",
                                 "--cache-dir", cache]),
            ("verify resnet101", ["verify", "--model", "resnet101", "--topo", "h100",
                                  "--cache-dir", cache, "--json"]),
            ("verify --selftest", ["verify", "--selftest"]),
            ("trace transformer", ["trace", "--model", "transformer", "--topo", "h100",
                                   "--out-dir", str(root / "cli-traces")]),
            ("policy train", ["policy", "train", "--models", "bert_small", "vgg19", "--name",
                              "obs", "--steps", str(OBS_POLICY_STEPS), "--mcts-iters",
                              str(OBS_POLICY_PLAYOUTS), "--cache-dir", cache])]
    timed = {"trace": [], "simplify": [], "partition": []}

    def timer(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timed[key].append(time.perf_counter() - t0)
            return out
        return run

    patched = [(cli_mod, "trace_training_graph"), (CompGraph, "simplify"), (cli_mod, "partition")]
    saved = [getattr(o, n) for o, n in patched]
    for (o, n), key in zip(patched, timed):
        setattr(o, n, timer(key, getattr(o, n)))
    results = []
    try:
        for label, argv in cmds:
            marks = {k: len(v) for k, v in timed.items()}
            t0 = time.perf_counter()
            rc, out = _stdout_of(cli_mod.main, argv, echo=False)
            secs = time.perf_counter() - t0
            graphs = ", ".join(
                f"{k} {' + '.join(f'{x:.2f}' for x in v[marks[k]:])} s"
                for k, v in timed.items() if len(v) > marks[k])
            res = json.loads(out)
            results.append((label, rc, res))
            log("obs", f"CLI {' '.join(argv[:3])}: rc {rc}, {secs:.2f} s"
                       + (f" ({graphs})" if graphs else "") + "; " + _cli_summary(res) + f"; {smi}")
    finally:
        for (o, n), f in zip(patched, saved):
            setattr(o, n, f)
    (_, rc1, cold), (_, rc2, hit) = results[0], results[1]
    if (rc1, cold["source"], rc2, hit["source"], hit["iterations_run"]) != (0, "cold", 0, "hit", 0):
        raise RuntimeError(f"plan bert_large: {cold['source']} then {hit['source']}")
    if any(rc for _, rc, _ in results[2:]) or not results[3][2]["ok"]:
        raise RuntimeError(f"CLI exit codes {[rc for _, rc, _ in results]}")
    if sorted(results[4][2]["schedules"]) != sorted(cli_mod.SCHEDULES):
        raise RuntimeError(f"trace schedules {sorted(results[4][2]['schedules'])}")


def _cli_summary(res: dict) -> str:
    if "ok" in res:
        return f"selftest ok {res['ok']}"
    if "schedules" in res:
        return "step_error_frac " + ", ".join(
            f"{k} {v['step_error_frac']:.3e} (predicted {v['predicted_step_s'] * 1e3:.3f} ms, "
            f"bubble {v['bubble_frac']:.3f})" for k, v in res["schedules"].items())
    if "registered" in res:
        return f"registered {res['registered']}, final_loss {res['final_loss']}"
    if "verdict" in res:
        return f"source {res['source']}, verdict {res['verdict']}, {res['summary']}"
    if "source" in res:
        key = '{source="%s"}' % res["source"]
        seconds = res["stats"]["metrics"]["planner_plan_seconds"]["series"][key]["sum"]
        return (f"source {res['source']}, {res['iterations_run']} playouts, plan_graph "
                f"{seconds:.3f} s, simulated {res['time_s'] * 1e3:.3f} ms, speedup "
                f"{res['speedup']}")
    return json.dumps(res)[:200]


def obs_mlp(smi: str):
    """Step 5: ``dp_mlp_loss`` over ``[cuda:0] * 2`` and ``* 4`` for each
    sync mode, f32, TF32 off, against the same MLP on one device: each
    leaf's gradient within ``DP_TOL`` of its max (the DP gate's rule)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sfb_dense import dp_mlp_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ps = [(torch.randn(a, b, device=dev, generator=gen) / a ** 0.5).requires_grad_()
          for a, b in zip(OBS_MLP_WIDTHS[:-1], OBS_MLP_WIDTHS[1:])]
    x = torch.randn(OBS_MLP_ROWS, OBS_MLP_WIDTHS[0], device=dev, generator=gen)
    y = torch.randn(OBS_MLP_ROWS, OBS_MLP_WIDTHS[-1], device=dev, generator=gen)
    h = x
    for i, w in enumerate(ps):
        h = h @ w if i == len(ps) - 1 else torch.relu(h @ w)
    one = torch.autograd.grad(((h - y) ** 2).mean(), ps)
    errs = {}
    for k in (2, 4):
        for sync in ("allreduce", "ps", "sfb"):
            loss = dp_mlp_loss(make_mesh((k,), ("data",), [dev] * k), "data", sync,
                               OBS_MLP_WIDTHS)
            got = torch.autograd.grad(loss(ps, x, y), ps)
            errs[(k, sync)] = max(_rel(g, r) for g, r in zip(got, one))
    torch.backends.cuda.matmul.allow_tf32 = True
    log("obs", f"dp_mlp_loss, widths {OBS_MLP_WIDTHS}, batch {OBS_MLP_ROWS}, f32: max |g - g1| "
               f"/ max |g1| a leaf against one device "
               f"{ {f'{s} x{k}': f'{e:.3e}' for (k, s), e in errs.items()} } (tolerance "
               f"{DP_TOL:g}); {smi}")
    if not all(e <= DP_TOL for e in errs.values()):
        raise RuntimeError(f"dp_mlp_loss gradients off: {errs}")


def phase_obs(root: Path, tag_losses: list, watch: tuple, smi: str):
    """The observability plane on the card (steps 1, 3, 4 and 5; step 2 ran
    inside the pipeline phase)."""
    t0 = time.perf_counter()
    obs_train(root, tag_losses, smi)
    t1 = time.perf_counter()
    obs_serve(root, watch, smi)
    t2 = time.perf_counter()
    obs_cli(root, smi)
    t3 = time.perf_counter()
    obs_mlp(smi)
    log("obs", f"seconds: train {t1 - t0:.1f}, serve {t2 - t1:.1f}, CLI {t3 - t2:.1f}, "
               f"dp_mlp_loss {time.perf_counter() - t3:.1f}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev).clone()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phase = "env"
    obs_root = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    try:
        smi = phase_env()
        phase = "build"
        phase_build()
        phase = "kernel"
        kernels = phase_kernel(args.seed, smi)
        by_name = {k["name"]: k for k in kernels}
        for k in kernels:
            k["launches"] = 0
        for arch in SERVE_ARCHS:
            phase = "serve"
            counts, model = phase_serve(arch, args.seed)
            for name, n in counts.items():
                by_name[name]["launches"] += n
            phase = "profile"
            phase_profile(*model)
            del model
            torch.cuda.empty_cache()
        missing = [k["name"] for k in kernels if not k["launches"]]
        if missing:
            raise RuntimeError(f"kernels of the path never launched on the main path: {missing}")
        phase = "parity"
        parity_flash(args.seed)
        parity_ssd(args.seed)
        phase = "train"
        train_ms = {arch: phase_train(arch, args.seed) for arch in (QWEN, MAMBA)}
        train_ms[OLMOE] = phase_train(OLMOE, args.seed, layers=MOE_TRAIN_LAYERS)
        for arch in (QWEN, MAMBA, OLMOE):
            train_parity(arch, args.seed)
        phase = "plan"
        graphs = {arch: plan_trace(arch, smi) for arch in (QWEN, MAMBA)}
        plan_gemm_profile(smi)
        tag_losses = plan_tag_search(smi)
        qwen_gg, qwen_plan = plan_search(QWEN, graphs.pop(QWEN), smi)
        plan_search(MAMBA, graphs.pop(MAMBA), smi)
        phase = "dp"
        reset_counts()
        phase_dp(args.seed, smi)
        counts = read_counts()
        log("dp", f"kernel launches over the phase: {counts} (none expected: data parallelism "
                  f"trains and decodes through the models' own routes)")
        if any(counts.values()):
            raise RuntimeError(f"the dp path launched a forward-only kernel: {counts}")
        phase = "pipeline"
        reset_counts()
        dev = torch.device("cuda", 0)
        pipeline_gate(dev, args.seed, smi)
        pipeline_gate_moe(dev, args.seed, smi)
        pipeline_run(dev, args.seed, train_ms[QWEN], smi, obs_root=obs_root)
        pipe_records = []
        hand_runs = pipeline_run(dev, args.seed, train_ms[QWEN], smi, searched=False,
                                 stage_flops=qwen_gg.base.total_flops() / 2,
                                 telemetry=pipe_records, obs_root=obs_root)
        counts = read_counts()
        log("pipeline", f"kernel launches over the phase: {counts} (none expected: the engine "
                        f"trains through the models' own routes)")
        if any(counts.values()):
            raise RuntimeError(f"the pipeline path launched a forward-only kernel: {counts}")
        phase = "service"
        reset_counts()
        t0 = time.perf_counter()
        phase_service(args.seed, pipe_records, qwen_gg, qwen_plan, smi)
        counts = read_counts()
        log("service", f"kernel launches over the phase: {counts} (none expected: serving "
                       f"steps the prompt through the decode path); {time.perf_counter() - t0:.1f} "
                       f"s in all")
        if any(counts.values()):
            raise RuntimeError(f"the service path launched a forward-only kernel: {counts}")
        phase = "obs"
        reset_counts()
        phase_obs(obs_root, tag_losses, hand_runs["eager"], smi)
        counts = read_counts()
        log("obs", f"kernel launches over the phase: {counts} (none expected: training, the "
                   f"planner and the CLI run the plain routes)")
        if any(counts.values()):
            raise RuntimeError(f"the obs path launched a forward-only kernel: {counts}")
        phase = "kernels"
        for k in kernels:
            library = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
            log("kernels", f"{k['name']} ({k['route']}, {k['source']}): check ok, "
                           f"launches {k['launches']}, {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                           f"library {library}, bound {k['bound_ms']:.5f} ms ({k['bound_by']})")
    except Exception:
        traceback.print_exc()
        print(f"[{phase}] FAILED", flush=True)
        return 1
    finally:
        shutil.rmtree(obs_root, ignore_errors=True)
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
