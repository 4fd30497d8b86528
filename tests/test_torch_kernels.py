"""Port parity, kernels: ``repro_torch.kernels`` on the CPU (the plain
versions the wrapper runs for CPU tensors) against ``repro.kernels``, the
Pallas kernel run in interpret mode and its jnp oracle, on the sweeps of
tests/test_kernels.py. Inputs are drawn once with numpy and fed to both.

Tolerances are those of tests/test_kernels.py: f32 2e-5 (summation order),
bf16 3e-2 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ops import gqa_flash_attention as jax_gqa_flash
from repro.kernels.ref import ref_attention as jax_ref
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.ops import gqa_flash_attention
from repro_torch.kernels.ref import ref_attention

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _pair(rng, shape, dtype):
    """The same numbers as a jnp array and a CPU tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bhsd(t):
    """Port layout (B, S, H, hd) -> the JAX kernel's (B, H, S, hd), as numpy."""
    return _np(t).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,bq,bk", [
    (128, 64, 64, 64),
    (256, 64, 128, 64),
    (256, 32, 64, 128),
    (128, 128, 128, 128),
])
def test_flash_attention_causal(S, hd, bq, bk, dtype):
    rng = np.random.default_rng(S + hd + bq)
    B, H = 2, 2
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (B, H, S, hd), dtype) for _ in range(3))
    atol = DTYPES[dtype][2]
    o_jax = jax_flash(qj, kj, vj, causal=True, block_q=bq, block_k=bk)
    o = gqa_flash_attention(qt.transpose(1, 2).contiguous(), kt.transpose(1, 2).contiguous(),
                            vt.transpose(1, 2).contiguous(), causal=True,
                            block_q=bq, block_k=bk)
    assert o.dtype == qt.dtype and o.shape == (B, S, H, hd)
    np.testing.assert_allclose(_bhsd(o), _np(o_jax), atol=atol)
    np.testing.assert_allclose(_np(ref_attention(qt, kt, vt, causal=True)),
                               _np(jax_ref(qj, kj, vj, causal=True)), atol=atol)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_flash_attention_sliding_window(window):
    rng = np.random.default_rng(window)
    B, H, S, hd = 1, 2, 256, 32
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (B, H, S, hd), "float32") for _ in range(3))
    o_jax = jax_flash(qj, kj, vj, causal=True, window=window, block_q=64, block_k=64)
    o = gqa_flash_attention(*(t.transpose(1, 2) for t in (qt, kt, vt)),
                            causal=True, window=window)
    np.testing.assert_allclose(_bhsd(o), _np(o_jax), atol=2e-5)
    np.testing.assert_allclose(_np(ref_attention(qt, kt, vt, window=window)),
                               _np(jax_ref(qj, kj, vj, window=window)), atol=2e-5)


def test_flash_attention_noncausal():
    rng = np.random.default_rng(7)
    B, H, S, hd = 1, 1, 128, 64
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, (B, H, S, hd), "float32") for _ in range(3))
    o_jax = jax_flash(qj, kj, vj, causal=False, block_q=64, block_k=64)
    o = gqa_flash_attention(*(t.transpose(1, 2) for t in (qt, kt, vt)), causal=False)
    np.testing.assert_allclose(_bhsd(o), _np(o_jax), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_wrapper_matches_jax_gqa(dtype):
    """KV heads shared by G = H // KV query heads, in the model's layout."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 128, 4, 2, 32
    qj, qt = _pair(rng, (B, S, H, hd), dtype)
    kj, kt = _pair(rng, (B, S, KV, hd), dtype)
    vj, vt = _pair(rng, (B, S, KV, hd), dtype)
    o_jax = jax_gqa_flash(qj, kj, vj, block_q=64, block_k=64)
    o = gqa_flash_attention(qt, kt, vt, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(o), _np(o_jax), atol=DTYPES[dtype][2])


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (1, 64, 2, 32), "float32")
    before = fa_mod.flash_attention.launches
    fa_mod.flash_attention(q, q, q)
    assert fa_mod.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["kv_len", "heads", "dtype", "rank"])
def test_flash_attention_rejects_bad_inputs(bad):
    q = torch.zeros(1, 64, 4, 32)
    k = torch.zeros(1, 64, 2, 32)
    if bad == "kv_len":
        k = torch.zeros(1, 32, 2, 32)
    elif bad == "heads":
        k = torch.zeros(1, 64, 3, 32)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa_mod.flash_attention(q, k, k)
