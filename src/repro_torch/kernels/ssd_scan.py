"""Mamba-2 SSD chunked scan: the wrapper of the CUDA kernels in
``csrc/ssd_scan.cu`` (bf16 on the tensor cores, one block per slice of 32
columns of hd; f32 on the CUDA cores), which replace the TPU kernel
``repro.kernels.ssd_scan``.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU tensor
it runs the plain version, ``ref.ref_ssd_chunked``. The kernel has no
backward, as the TPU kernel has none: on every device the wrapper refuses
inputs that record gradients, and the model trains through its own
``models.ssm.ssd_chunked`` (``attn_impl="jnp"``). ``ssd_scan.launches``
counts the kernel's launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_ssd_chunked

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _kernel():
    fn = build.load("ssd_scan").ssd_scan_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    # x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y, h,
    # Bb, S, nh, hd, g, ds, Q, is_bf16, stream
    fn.argtypes = [P, L, L, P, P, P, L, L, P, L, L, P, P, I, I, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def launch_plan(Bb: int, nh: int, hd: int, ds: int, chunk: int, dtype: torch.dtype) -> dict:
    """How ``dtype``'s kernel launches at these shapes: blocks, threads and
    dynamic shared memory (bytes) a block."""
    fn = build.load("ssd_scan").ssd_scan_plan
    I = ctypes.c_int
    fn.argtypes = [I, I, I, I, I, I, ctypes.POINTER(I)]
    fn.restype = I
    out = (I * 3)()
    fn(Bb, nh, hd, ds, chunk, int(dtype == torch.bfloat16), out)
    return dict(zip(("blocks", "threads", "smem_bytes"), out))


def _check(x, dt, A, B, C):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4:
        raise ValueError("x must be (Bb, S, nh, hd), dt (Bb, S, nh), A (nh,), B and C (Bb, S, g, ds)")
    Bb, S, nh, _ = x.shape
    if tuple(dt.shape) != (Bb, S, nh) or tuple(A.shape) != (nh,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x {tuple(x.shape)}")
    if B.shape != C.shape or tuple(B.shape[:2]) != (Bb, S) or nh % B.shape[2]:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} do not match x "
                         f"{tuple(x.shape)} (groups must divide {nh} heads)")
    if not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"dtypes differ: x {x.dtype}, B {B.dtype}, C {C.dtype}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("x, dt, A, B, C are on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "ssd_scan has no backward, and its outputs would carry no gradient: "
            "train through the model's own scan, models.ssm.ssd_chunked "
            "(attn_impl='jnp'), or call it under torch.no_grad()")


def _rows(t):
    """``t`` (Bb, S, n, k) with its last two dims packed, else a packed copy:
    the kernel takes the batch and position strides and nothing else."""
    if t.stride(3) == 1 and t.stride(2) == t.shape[3]:
        return t
    return t.contiguous()


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x: (Bb, S, nh, hd); dt: (Bb, S, nh) (already softplus'd); A: (nh,)
    negative decay rates; B, C: (Bb, S, g, ds), where head ``h`` reads group
    ``h // (nh // g)``. Returns y (Bb, S, nh, hd) in x's dtype and the final
    state h (Bb, nh, hd, ds) in f32.

    x, B and C may be strided views of one activation (the model splits them
    from the convolution's output): the kernel reads them in place.
    """
    _check(x, dt, A, B, C)
    Bb, S, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    if x.device.type == "cpu":
        rep = nh // g
        return ref_ssd_chunked(x, dt, A, B.repeat_interleave(rep, dim=2),
                               C.repeat_interleave(rep, dim=2), chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan takes {DTYPES}, not {x.dtype}")
    if Q > MAX_CHUNK or hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(f"chunk {Q}, head_dim {hd}, state {ds} exceed the kernel's "
                         f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    x, B, C = _rows(x), _rows(B), _rows(C)
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    y = torch.empty((Bb, S, nh, hd), dtype=x.dtype, device=x.device)
    h = torch.empty((Bb, nh, hd, ds), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(),
                        B.data_ptr(), B.stride(0), B.stride(1),
                        C.data_ptr(), C.stride(0), C.stride(1), y.data_ptr(), h.data_ptr(),
                        Bb, S, nh, hd, g, ds, Q, int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan_fwd failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
