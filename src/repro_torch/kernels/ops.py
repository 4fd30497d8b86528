"""Public entry points the model layers route through, as in
``repro.kernels.ops``."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan


def gqa_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 128, block_k: int = 128):
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd).

    The CUDA kernel indexes KV head ``h // G`` where the TPU version repeats
    the KV heads. ``block_q``/``block_k`` keep the TPU signature; the CUDA
    kernel's 64 x 64 tile is fixed by Hopper's shared memory, so only their
    validity is checked here.
    """
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive: {block_q}, {block_k}")
    return flash_attention(q, k, v, causal=causal, window=window)


def mamba_ssd(x, dt, A, B, C, D_skip=None, *, chunk: int = 128):
    """SSD scan + optional D-skip. Shapes as in ``kernels.ssd_scan``; B and C
    may carry groups. Returns (y, h): the JAX version drops the final state
    h, which the model's ``mamba_fwd`` returns."""
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk)
    if D_skip is not None:
        y = y + x * D_skip[None, None, :, None]
    return y, h
