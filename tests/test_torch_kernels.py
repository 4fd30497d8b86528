"""Port parity, kernels: ``repro_torch.kernels`` on the CPU (the plain
versions the wrapper runs for CPU tensors) against ``repro.kernels``, the
Pallas kernel run in interpret mode and its jnp oracle, on the sweeps of
tests/test_kernels.py. Inputs are drawn once with numpy and fed to both.

Tolerances are those of tests/test_kernels.py. Flash attention: f32 2e-5
(summation order), bf16 3e-2 (one bf16 rounding of the output). SSD scan:
f32 1e-4, bf16 1e-1 (sums over a chunk of up to 128 steps).
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
from repro.kernels.ops import mamba_ssd as jax_mamba_ssd
from repro.kernels.ref import ref_attention as jax_ref
from repro.kernels.ref import ref_ssd as jax_ref_ssd
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ops import gqa_flash_attention, mamba_ssd
from repro_torch.kernels.ref import ref_attention, ref_ssd, ref_ssd_chunked

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


# --------------------------------------------------------------- SSD scan

SSD_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-1)}
# (S, nh, hd, ds, chunk) of tests/test_kernels.py
SSD_SWEEPS = [(128, 2, 32, 16, 64), (256, 4, 64, 32, 128), (192, 1, 16, 8, 64)]


def _ssd_inputs(rng, S, nh, hd, ds, dtype, Bb=2, groups=None):
    """x, dt, A, B, C as (jnp, torch) pairs, drawn as tests/test_kernels.py
    draws them. B and C carry ``groups`` groups (default: one per head)."""
    jdt, tdt, _ = SSD_DTYPES[dtype]
    g = groups or nh
    draws = [rng.standard_normal((Bb, S, nh, hd)),
             rng.uniform(0.01, 0.2, (Bb, S, nh)),
             -rng.uniform(0.5, 2.0, (nh,)),
             rng.standard_normal((Bb, S, g, ds)),
             rng.standard_normal((Bb, S, g, ds))]
    out = []
    for i, a in enumerate(draws):
        a = a.astype(np.float32)
        if i == 2:                                    # A stays f32
            out.append((jnp.asarray(a), torch.from_numpy(a)))
        else:
            out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,nh,hd,ds,chunk", SSD_SWEEPS)
def test_ref_ssd_matches_jax(S, nh, hd, ds, chunk, dtype):
    """The sequential recurrence, y and h."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        np.random.default_rng(S + nh), S, nh, hd, ds, dtype)
    yj, hj = jax_ref_ssd(xj, dj, aj, bj, cj)
    y, h = ref_ssd(xt, dt_, at, bt, ct)
    atol = SSD_DTYPES[dtype][2]
    assert y.dtype == xt.dtype and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yj), atol=atol)
    np.testing.assert_allclose(_np(h), _np(hj), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,nh,hd,ds,chunk", SSD_SWEEPS)
def test_ref_ssd_chunked_matches_jax(S, nh, hd, ds, chunk, dtype):
    """The chunked algorithm against ``repro.models.ssm.ssd_chunked``, y and h."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        np.random.default_rng(S + hd), S, nh, hd, ds, dtype)
    yj, hj = jax_ssd_chunked(xj, dj, aj, bj, cj, chunk)
    y, h = ref_ssd_chunked(xt, dt_, at, bt, ct, chunk)
    atol = SSD_DTYPES[dtype][2]
    np.testing.assert_allclose(_np(y), _np(yj), atol=atol)
    np.testing.assert_allclose(_np(h), _np(hj), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,nh,hd,ds,chunk", SSD_SWEEPS)
def test_ssd_scan_cpu_route_matches_pallas(S, nh, hd, ds, chunk, dtype):
    """The wrapper's CPU route against the Pallas kernel in interpret mode
    (y) and the JAX recurrence (h, which the Pallas kernel drops)."""
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        np.random.default_rng(S + ds), S, nh, hd, ds, dtype)
    yj = jax_ssd_scan(xj, dj, aj, bj, cj, chunk=chunk)
    _, hj = jax_ref_ssd(xj, dj, aj, bj, cj)
    y, h = ssd_mod.ssd_scan(xt, dt_, at, bt, ct, chunk=chunk)
    atol = SSD_DTYPES[dtype][2]
    assert y.shape == xt.shape and y.dtype == xt.dtype
    np.testing.assert_allclose(_np(y), _np(yj), atol=atol)
    np.testing.assert_allclose(_np(h), _np(hj), atol=atol)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_ssd_with_groups_matches_jax(groups):
    """B and C with fewer groups than heads, against the JAX wrapper on the
    repeated heads (as ``repro.models.ssm.mamba_fwd`` repeats them), with
    the D-skip."""
    nh = 4
    (xj, xt), (dj, dt_), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(
        np.random.default_rng(groups), 128, nh, 32, 16, "float32", groups=groups)
    D = np.random.default_rng(9).standard_normal(nh).astype(np.float32)
    rep = nh // groups
    yj = jax_mamba_ssd(xj, dj, aj, jnp.repeat(bj, rep, axis=2), jnp.repeat(cj, rep, axis=2),
                       jnp.asarray(D), chunk=64)
    y, h = mamba_ssd(xt, dt_, at, bt, ct, torch.from_numpy(D), chunk=64)
    np.testing.assert_allclose(_np(y), _np(yj), atol=1e-4)
    _, hj = jax_ssd_chunked(xj, dj, aj, jnp.repeat(bj, rep, axis=2), jnp.repeat(cj, rep, axis=2),
                            64)
    np.testing.assert_allclose(_np(h), _np(hj), atol=1e-4)


def test_ssd_scan_cpu_call_launches_nothing():
    (_, xt), (_, dt_), (_, at), (_, bt), (_, ct) = _ssd_inputs(
        np.random.default_rng(0), 64, 2, 16, 8, "float32")
    before = ssd_mod.ssd_scan.launches
    ssd_mod.ssd_scan(xt, dt_, at, bt, ct, chunk=32)
    assert ssd_mod.ssd_scan.launches == before


@pytest.mark.parametrize("bad", ["ragged", "groups", "dtype", "dt_shape"])
def test_ssd_scan_rejects_bad_inputs(bad):
    """A sequence that is not a multiple of the chunk raises, where JAX
    asserts; so do groups that do not divide the heads and mixed dtypes."""
    S, nh, g = 96, 4, 1
    if bad == "ragged":
        S = 100
    elif bad == "groups":
        g = 3
    x = torch.zeros(1, S, nh, 16)
    dt = torch.zeros(1, S, nh if bad != "dt_shape" else nh + 1)
    B = torch.zeros(1, S, g, 8, dtype=torch.bfloat16 if bad == "dtype" else torch.float32)
    with pytest.raises(ValueError):
        ssd_mod.ssd_scan(x, dt, -torch.ones(nh), B, B.clone(), chunk=64)


def _hi_lo(a):
    """``a`` (f32) as the kernel hands it to the tensor cores: a bf16 high
    part and the bf16 residual, each exact in a bf16 product."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _split_mm(a, b, eq):
    """einsum(eq, a, b) with ``a`` split as the kernel splits it: the two
    products summed in f32, residual first."""
    hi, lo = _hi_lo(a)
    return torch.einsum(eq, lo, b) + torch.einsum(eq, hi, b)


def _sliced_ssd(x, dt, A, B, C, chunk, width=32):
    """Plain emulation of the bf16 SSD kernel's layout and arithmetic: hd in
    slices of ``width`` columns run separately (each recomputes C Bᵀ and the
    decays) and concatenated; per chunk, cum = cumsum(dt A) in f64 and kept
    in log2 units, the decays as exp2 of f32 differences (below a row's
    16-row block, i0 = 16 floor(i / 16), L[i][t] = 2^(cum_i - cum_i0)
    2^(cum_i0 - cum_t)), and the three products with an f32 operand
    (C Bᵀ ⊙ L · dt against x, C against h, x w against B) split into a bf16
    high part and residual. x, B, C: bf16 values in f32; B and C carry one
    group per head."""
    log2e = 1.4426950408889634
    Bb, S, nh, hd = x.shape
    Q = min(chunk, S)
    ys, hs = [], []
    for d0 in range(0, hd, width):
        xs = x[..., d0:d0 + width]
        h = torch.zeros(Bb, nh, xs.shape[-1], B.shape[-1])
        y = torch.empty_like(xs)
        for c0 in range(0, S, Q):
            xc, dtc = xs[:, c0:c0 + Q], dt[:, c0:c0 + Q]
            Bc, Cc = B[:, c0:c0 + Q], C[:, c0:c0 + Q]
            cum = torch.cumsum((dtc * A).double(), dim=1)                 # (Bb, Q, nh)
            cum2 = (cum * log2e).float()
            w = dtc * torch.exp2(((cum[:, -1:] - cum) * log2e).float())
            G = torch.einsum("bins,btns->bnit", Cc, Bc)                     # exact products
            c2 = cum2.transpose(1, 2)                                     # (Bb, nh, Q)
            i0 = torch.arange(Q) // 16 * 16                               # each row's block
            ci0 = c2[..., i0]
            below = torch.exp2(c2 - ci0)[..., :, None] * torch.exp2(ci0[..., :, None]
                                                                    - c2[..., None, :])
            L = torch.where(torch.arange(Q)[None, :] < i0[:, None], below,
                            torch.exp2(c2[..., :, None] - c2[..., None, :])).tril()
            M = G * L * dtc.transpose(1, 2)[:, :, None, :]
            y_intra = _split_mm(M, xc, "bnit,btnd->bind")
            y_inter = _split_mm(h, Cc, "bnds,bins->bind")
            y[:, c0:c0 + Q] = y_intra + y_inter * torch.exp2(cum2)[..., None]
            h = (h * torch.exp2(c2[..., -1])[..., None, None]
                 + _split_mm(xc * w[..., None], Bc, "btnd,btns->bnds"))
        ys.append(y)
        hs.append(h)
    return torch.cat(ys, dim=-1), torch.cat(hs, dim=-2)


@pytest.mark.parametrize("model_dt", [False, True])
@pytest.mark.parametrize("S,nh,hd,ds,chunk", SSD_SWEEPS + [(256, 2, 48, 32, 128),
                                                           (128, 2, 24, 16, 64)])
def test_sliced_ssd_emulation_matches_jax(S, nh, hd, ds, chunk, model_dt):
    """The algebra the bf16 SSD kernel relies on, in f32 on the CPU, against
    ``repro.models.ssm.ssd_chunked``: y within 1e-4 (relative to max |y| with
    the model's dt, where cum falls to about -96 within a chunk and |y|
    reaches about 1e2), h within 1e-4 x max(1, max |h|). x, B and C are
    bf16 values, as the kernel takes them."""
    rng = np.random.default_rng(S + hd + int(model_dt))
    Bb = 2

    def bf16_values(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    x, B, C = bf16_values(Bb, S, nh, hd), bf16_values(Bb, S, nh, ds), bf16_values(Bb, S, nh, ds)
    if model_dt:   # as the full-width model draws them: softplus(N(0, 0.55^2)), A = -1
        dt = np.log1p(np.exp(0.55 * rng.standard_normal((Bb, S, nh)))).astype(np.float32)
        A = -np.ones(nh, np.float32)
    else:
        dt = rng.uniform(0.01, 0.2, (Bb, S, nh)).astype(np.float32)
        A = -rng.uniform(0.5, 2.0, nh).astype(np.float32)
    yj, hj = jax_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)
    y, h = _sliced_ssd(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk)
    yj, hj = np.asarray(yj), np.asarray(hj)
    y_tol = 1e-4 * (max(1.0, np.abs(yj).max()) if model_dt else 1.0)
    np.testing.assert_allclose(y.numpy(), yj, atol=y_tol, rtol=0)
    np.testing.assert_allclose(h.numpy(), hj, atol=1e-4 * max(1.0, np.abs(hj).max()), rtol=0)


# ------------------------------------------------ no backward: autograd refused

def _model_attention_inputs(impl):
    """Reduced qwen2 attention weights that record gradients, and an input."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import attention as tattn
    from repro_torch.models.layers import init_tree
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32", attn_impl=impl)
    p = init_tree(tattn.attn_defs(cfg), torch.Generator().manual_seed(0), torch.float32)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64, cfg.d_model))
                         .astype(np.float32))
    return cfg, p, x, tattn


@pytest.mark.parametrize("route", ["flash_attention", "attention_pallas", "mamba_ssd"])
def test_kernel_routes_refuse_autograd(route):
    """The kernels have no backward (nor have the TPU kernels): a kernel route
    given inputs that record gradients raises, on the CPU as on the card,
    where its output would otherwise carry no gradient. Before this was
    enforced the CPU route ran the differentiable plain version, and the same
    call on the card silently dropped the gradients of q, k, v (and of
    everything before the SSD scan)."""
    rng = np.random.default_rng(4)
    if route == "flash_attention":
        q = torch.from_numpy(rng.standard_normal((1, 64, 2, 32)).astype(np.float32))
        k = q.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="attn_impl='jnp'"):
            gqa_flash_attention(q, k, q.clone())
        with torch.no_grad():                 # inference is unaffected
            gqa_flash_attention(q, k, q.clone())
    elif route == "attention_pallas":
        cfg, p, x, tattn = _model_attention_inputs("pallas")
        pos = torch.arange(x.shape[1])
        with pytest.raises(RuntimeError, match="no backward"):
            tattn.attention(cfg, p, x, pos)
        out, _ = tattn.attention(cfg.replace(attn_impl="jnp"), p, x, pos)
        out.sum().backward()                  # the model's own attention trains
        assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in p.values())
    else:
        (_, xt), (_, dt_), (_, at), (_, bt), (_, ct) = _ssd_inputs(rng, 64, 2, 16, 8, "float32")
        dt_.requires_grad_(True)
        with pytest.raises(RuntimeError, match="models.ssm.ssd_chunked"):
            mamba_ssd(xt, dt_, at, bt, ct, chunk=32)
        with torch.inference_mode():
            y, _ = mamba_ssd(xt, dt_, at, bt, ct, chunk=32)
        assert y.shape == xt.shape
