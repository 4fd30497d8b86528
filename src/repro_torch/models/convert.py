"""Move parameter trees between ``repro`` and the port without importing JAX.

``repro``'s trees are nested dicts; the caller hands them over as numpy
(``jax.tree.map(np.asarray, params)``). The port keeps the same keys and
shapes, stacked ``blocks`` leaves included, so conversion is leaf by leaf.
numpy has no bfloat16 of its own: such leaves arrive as ``ml_dtypes.bfloat16``
and cross by their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(a: np.ndarray, device) -> torch.Tensor:
    # a copy: the caller's arrays may be read-only, and tensors on the CPU
    # would otherwise share their memory
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device):
    """Nested dict of numpy arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_to_torch(np.asarray(tree), device)


def params_to_numpy(tree):
    """Tensors -> numpy on the host. bfloat16 leaves come back as their bit
    pattern (uint16); ``.view(ml_dtypes.bfloat16)`` restores the type."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()
