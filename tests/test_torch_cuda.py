"""The CUDA kernels on the card against their plain versions on the same
inputs. Needs a CUDA device and nvcc; skips without a card.

Run on the card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Tolerances: f32 2e-5 (summation order; TF32 off for the plain version),
bf16 3e-2 (one bf16 rounding of the output), as tests/test_kernels.py. In
bf16 the output may also differ from the plain version run in f32 by at
most 1e-4 beyond half a bf16 step: P V is computed in f32 precision, as on
the TPU (P rounded to bf16 would exceed it by about 3e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.ref import ref_gqa_attention

CASES = {
    # name: (B, S, H, KV, hd, causal, window)
    "serve_slice": (4, 512, 12, 2, 128, True, 0),
    "mha_hd64": (2, 256, 2, 2, 64, True, 0),
    "window_100": (1, 256, 2, 2, 32, True, 100),
    "noncausal": (1, 128, 1, 1, 64, False, 0),
    "ragged_causal": (2, 100, 4, 2, 80, True, 0),
    "ragged_window": (1, 200, 4, 1, 16, True, 48),
    "ragged_noncausal": (1, 70, 2, 2, 128, False, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(case, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, hd, causal, window = CASES[case]
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dt)

    q, k, v = rand(B, S, H, hd), rand(B, S, KV, hd), rand(B, S, KV, hd)
    before = fa_mod.flash_attention.launches
    o = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_mod.flash_attention.launches == before + 1
    ref = ref_gqa_attention(q, k, v, causal=causal, window=window)
    assert o.dtype == dt and o.shape == q.shape
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= atol, (case, dtype, err)
    if dt == torch.bfloat16:                  # against the plain version in f32
        ref = ref_gqa_attention(q.float(), k.float(), v.float(), causal=causal, window=window)
        _, e = torch.frexp(ref)
        half_ulp = torch.where(ref == 0, 0.0, torch.exp2((e - 9).float()))
        excess = ((o.float() - ref).abs() - half_ulp).max().item()
        assert excess <= 1e-4, (case, excess)
