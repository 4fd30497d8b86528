"""Flash attention forward: the wrapper of the CUDA kernels in
``csrc/flash_attention.cu`` (bf16 by TMA and wgmma, the query heads of one KV
head in one block; f32 on the CUDA cores), which replace the TPU kernel
``repro.kernels.flash_attention``.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs the plain version, ``ref.ref_gqa_attention``. The kernel has no
backward, as the TPU kernel has none: on every device the wrapper refuses
inputs that record gradients, and the model trains through its own
attention (``attn_impl="jnp"``). ``flash_attention.launches``
counts the kernel's launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_gqa_attention

MAX_HEAD_DIM = 128
DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, B, S, H, KV, hd, causal, window, scale, is_bf16, stream
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, P]
    fn.restype = I
    return fn


def launch_plan(B: int, S: int, H: int, KV: int, hd: int, dtype: torch.dtype) -> dict:
    """How ``dtype``'s kernel launches at these shapes: blocks, threads and
    dynamic shared memory (bytes) a block, query heads a block."""
    fn = build.load("flash_attention").flash_attention_plan
    I = ctypes.c_int
    fn.argtypes = [I, I, I, I, I, I, ctypes.POINTER(I)]
    fn.restype = I
    out = (I * 4)()
    if fn(B, S, H, KV, hd, int(dtype == torch.bfloat16), out):
        raise ValueError(f"flash_attention takes no launch at B={B} S={S} H={H} KV={KV} hd={hd}")
    return dict(zip(("blocks", "threads", "smem_bytes", "heads_per_block"), out))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H|KV, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward, and its output would carry no gradient: "
            "train through the model's own attention (attn_impl='jnp'), or call it "
            "under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd) in q's dtype.

    Query head ``h`` attends with KV head ``h // (H // KV)``. ``window`` > 0
    keeps keys ``k > q - window``, and only when ``causal``. Any S works: the
    kernel masks a ragged last tile.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref_gqa_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, not {q.dtype}")
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is not a multiple of 16 up to {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention needs q, k, v aligned to 16 bytes")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        B, S, H, k.shape[2], hd, int(causal), int(window), hd ** -0.5,
                        int(q.dtype == torch.bfloat16),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
