"""Batched serving loop: build the cache (KV ring for attention layers,
conv ring and SSM state for Mamba-2 layers) from a batch of prompts, then
decode tokens greedily against it.

    python -m repro_torch.launch.serve --arch mamba2-130m --smoke \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Deployment planning (``--plan-topo``) and the measured-time feedback loop
(``--observe``) of ``repro.launch.serve`` wait for the planner slice
(ROADMAP, queue 1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.device import resolve_device
from repro_torch.models.model import init_cache, init_params


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, gen_tokens: int, stats: dict | None = None):
    """prompts: (B, P) integer tokens. Returns (B, gen_tokens) int64 on the
    parameters' device.

    As in ``repro.launch.serve.generate``, the prompt is stepped through the
    decode path one token at a time to build the cache; the fused prefill is
    ``launch.steps.make_prefill_step``. When ``stats`` is given it is filled
    with ``prefill_s``, ``decode_s`` and ``decode_steps``, each time taken
    after the device has finished its work.
    """
    device = params["embed"].device
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=device)
    B, P = prompts.shape
    cache = init_cache(cfg, B, P + gen_tokens, device)
    step = steps_mod.make_serve_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    pos = 0
    for i in range(P):
        nxt, cache = step(params, cache, prompts[:, i:i + 1], pos)
        pos += 1
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = []
    cur = nxt
    for _ in range(gen_tokens):
        out.append(cur)
        cur, cache = step(params, cache, cur, pos)
        pos += 1
    res = torch.cat(out, dim=1)
    _sync(device)
    if stats is not None:
        stats.update(prefill_s=t_prefill, decode_s=time.perf_counter() - t0,
                     decode_steps=gen_tokens)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on {device}")
    t0 = time.perf_counter()
    stats: dict = {}
    out = generate(cfg, params, prompts, args.gen, stats=stats)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} tokens on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s; prompt {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
