"""Device selection: the port runs on the card unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(name=None) -> torch.device:
    """``cuda`` when ``name`` is None. Raises when CUDA is asked for and no
    card is present: nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
