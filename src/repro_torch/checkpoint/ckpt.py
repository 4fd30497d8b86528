"""Flat-npz checkpoints with tree structure and dtype metadata, in the
format of ``repro.checkpoint.ckpt``: a checkpoint written by either package
loads in the other, bit for bit.

Tree leaves are flattened to ``path.to.leaf`` keys. bf16 tensors are stored
as their uint16 bit pattern (npz has no bf16) and marked ``bfloat16`` in the
``.meta.json`` beside the npz.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.launch.device import resolve_device

_BF16 = "bfloat16"


def _flatten_tree(tree, path=(), flat=None):
    # no recursive closure: it would hold the tensors in a reference cycle
    flat = {} if flat is None else flat
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_tree(v, path + (k,), flat)
    else:
        flat[".".join(path)] = tree
    return flat


def _unflatten(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_checkpoint(path: str, step: int, tree) -> str:
    """Write ``tree`` (nested dicts of tensors) as ``ckpt_<step>.npz`` under
    ``path``. Returns the npz's file name."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {}
    for k, t in _flatten_tree(tree).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[k] = t.view(torch.uint16).numpy()
            meta[k] = _BF16
        else:
            arrays[k] = t.numpy()
            meta[k] = str(arrays[k].dtype)
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fn, **arrays)
    with open(fn + ".meta.json", "w") as f:
        json.dump({"step": step, "dtypes": meta}, f)
    return fn


def latest_step(path: str):
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: int | None = None, device=None):
    """(step, tree of tensors on ``device``): the checkpoint at ``step``, or
    the latest one. ``device`` is cuda unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    with open(fn + ".meta.json") as f:
        meta = json.load(f)
    flat = {}
    with np.load(fn) as data:
        for k in data.files:
            t = torch.from_numpy(np.array(data[k]))
            if meta["dtypes"].get(k) == _BF16:
                t = t.view(torch.bfloat16)
            flat[k] = t.to(dev)
    return step, _unflatten(flat)
