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
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.device import resolve_device
from repro_torch.models.model import init_cache, init_params
from repro_torch.optim.adam import leaves


def _sync(devices):
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def generate(cfg, params, prompts, gen_tokens: int, rules=None, prefix=None,
             stats: dict | None = None):
    """prompts: (B, P) integer tokens. Returns (B, gen_tokens) int64 on the
    parameters' device. ``prefix`` is accepted as ``repro``'s ``generate``
    accepts it and, as there, not fed: the cache counts a frontend's
    ``cfg.frontend_tokens`` all the same.

    As in ``repro.launch.serve.generate``, the prompt is stepped through the
    decode path one token at a time to build the cache; the fused prefill is
    ``launch.steps.make_prefill_step``. Under ``rules`` whose batch axes
    span several devices (``launch.steps.data_devices``), each device holds
    a cache of its rows (the batch entry of ``cache_shardings``: the rows
    are split where the device count divides B, else every device decodes
    every row) and decodes them; the tokens are concatenated in device
    order. When ``stats`` is given it is filled with ``prefill_s``,
    ``decode_s`` and ``decode_steps``, each time taken after every device
    has finished its work.
    """
    device = params["embed"].device
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=device)
    del prefix
    B, P = prompts.shape
    total = P + gen_tokens + (cfg.frontend_tokens if cfg.frontend != "none" else 0)
    devices = steps_mod.data_devices(cfg, rules) or [device]
    if len(devices) > 1:
        shape = InputShape("generate", total, B, "decode")
        spec = leaves(steps_mod.cache_shardings(cfg, shape, rules))[0].spec
        rows = B // len(devices) if len(spec) > 1 and spec[1] is not None else B
        cache = [init_cache(cfg, rows, total, d) for d in devices]
    else:
        cache = init_cache(cfg, B, total, device)
    step = steps_mod.make_serve_step(cfg, rules)

    _sync(devices)
    t0 = time.perf_counter()
    pos = 0
    for i in range(P):
        nxt, cache = step(params, cache, prompts[:, i:i + 1], pos)
        pos += 1
    _sync(devices)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = []
    cur = nxt
    for _ in range(gen_tokens):
        out.append(cur)
        cur, cache = step(params, cache, cur, pos)
        pos += 1
    res = torch.cat(out, dim=1)
    _sync(devices)
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
    mesh = mesh_mod.make_host_mesh(None if device.type == "cuda" else [device])
    rules = steps_mod.baseline_rules(mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}) on {device}, "
          f"data parallel over the host mesh {mesh.shape}")
    t0 = time.perf_counter()
    stats: dict = {}
    out = generate(cfg, params, prompts, args.gen, rules, stats=stats)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} tokens on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s; prompt {stats['prefill_s']:.2f}s, "
          f"decode {stats['decode_s']:.2f}s)")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
