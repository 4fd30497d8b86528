"""Port parity, Mamba-2: ``repro_torch.models.ssm`` and the model built on it,
on the CPU, against ``repro.models`` on reduced mamba2-130m (2 layers,
d_model 128, 8 SSM heads of 32, d_state 16), from the same weights.

The JAX package draws the parameters; the zero- and one-initialised leaves
(``A_log``, ``dt_bias``, ``D_skip``, ``conv_b``, ``norm``) get random values
so that every path is exercised. Activations and tokens are drawn with numpy
from a seed and fed to both. Tolerances: f32 1e-5 on single layers and 1e-4
on the model (the two frameworks sum in another order); bf16 5e-2 (bf16
rounds at other places in the two frameworks); decode against the full
forward 2e-2, the JAX package's own check (tests/test_models.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import models as jmodels
from repro.configs import get_reduced as jax_get_reduced
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy, params_to_numpy

ARCH = "mamba2-130m"
CPU = torch.device("cpu")
F32_MODEL_ATOL = 1e-4
F32_LAYER_ATOL = 1e-5
BF16_ATOL = 5e-2
DECODE_VS_FORWARD_ATOL = 2e-2


def _cfgs(dtype="float32", **kw):
    """The same reduced config in both packages."""
    return (jax_get_reduced(ARCH).replace(dtype=dtype, **kw),
            get_reduced(ARCH).replace(dtype=dtype, **kw))


def _weights(jcfg, seed=0):
    """JAX parameters, with random values in the constant-initialised
    leaves, and the port's copy of them on the CPU."""
    jp = jax.tree.map(np.asarray, jmodels.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for layer in jp["blocks"].values():
        m = layer["mixer"]
        draws = {"A_log": rng.uniform(-1.0, 1.0, m["A_log"].shape),
                 "dt_bias": 0.5 * rng.standard_normal(m["dt_bias"].shape),
                 "D_skip": 1.0 + 0.5 * rng.standard_normal(m["D_skip"].shape),
                 "conv_b": 0.1 * rng.standard_normal(m["conv_b"].shape),
                 "norm": 1.0 + 0.1 * rng.standard_normal(m["norm"].shape)}
        for name, v in draws.items():
            m[name] = v.astype(m[name].dtype)
    return jp, params_from_numpy(jp, CPU)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer0(tree):
    """Period 0, layer 0 of a stacked parameter tree (numpy or tensors)."""
    return jax.tree.map(lambda a: a[0], tree["blocks"]["layer0"])


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


# ------------------------------------------------------------------ layers

def test_causal_conv_matches():
    rng = np.random.default_rng(0)
    xbc = rng.standard_normal((2, 16, 48)).astype(np.float32)
    w = rng.standard_normal((4, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    ref = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    out = tssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)


@pytest.mark.parametrize("chunk,ngroups", [(128, 1), (32, 1), (32, 2)])
def test_mamba_fwd_matches(chunk, ngroups):
    """One chunk, four chunks, and B/C with two groups over the 8 heads."""
    jcfg, tcfg = _cfgs(ssm_chunk=chunk, ssm_ngroups=ngroups)
    jp, tp = _weights(jcfg)
    u = np.random.default_rng(2).standard_normal((2, 128, 128)).astype(np.float32)
    ref, rh = jssm.mamba_fwd(jcfg, _layer0(jp)["mixer"], jnp.asarray(u))
    out, h = tssm.mamba_fwd(tcfg, _layer0(tp)["mixer"], torch.from_numpy(u))
    assert h.dtype == torch.float32 and tuple(h.shape) == tuple(rh.shape)
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)
    np.testing.assert_allclose(_np(h), _np(rh), atol=F32_LAYER_ATOL)


def test_mamba_decode_matches():
    """One token against a filled conv ring and state; both caches are
    updated in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(3)
    cache = {k: _np(v) for k, v in jssm.init_ssm_cache(jcfg, 2, jnp.float32).items()}
    cache = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in cache.items()}
    u = rng.standard_normal((2, 1, 128)).astype(np.float32)
    ref, rcache = jssm.mamba_decode(jcfg, _layer0(jp)["mixer"], jnp.asarray(u),
                                    {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ring, state = tcache["conv"], tcache["h"]
    out, tcache = tssm.mamba_decode(tcfg, _layer0(tp)["mixer"], torch.from_numpy(u), tcache)
    assert tcache["conv"] is ring and tcache["h"] is state
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(tcache[name]), _np(rcache[name]), atol=F32_LAYER_ATOL)


def test_init_ssm_cache_dtypes():
    _, tcfg = _cfgs("bfloat16")
    cache = tssm.init_ssm_cache(tcfg, 3, torch.bfloat16, CPU)
    assert cache["h"].dtype == torch.float32 and tuple(cache["h"].shape) == (3, 8, 32, 16)
    assert cache["conv"].dtype == torch.bfloat16 and tuple(cache["conv"].shape) == (3, 3, 288)


# ------------------------------------------------------------------- model

def test_forward_and_prefill_match():
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    tokens = _tokens(jcfg, 2, 256)
    h_ref, _, _ = jmodels.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, remat=False)
    h, _, _ = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, remat=False)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=F32_MODEL_ATOL)
    lg_ref = jmodels.prefill_step(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    lg = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert tuple(lg.shape) == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=F32_MODEL_ATOL)


def test_bf16_prefill_matches():
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _weights(jcfg)
    tokens = _tokens(jcfg, 2, 128, seed=7)
    lg_ref = jmodels.prefill_step(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    lg = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert lg.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=BF16_ATOL)


def test_mamba_fwd_routes_by_attn_impl(monkeypatch):
    """The model's own ``ssd_chunked`` unless the caller asks for the kernel
    route (``attn_impl="pallas"``), as ``repro``'s ``mamba_fwd`` never calls
    the kernel; both routes give the same output."""
    jcfg, tcfg = _cfgs()
    _, tp = _weights(jcfg)
    p = _layer0(tp)["mixer"]
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 64, 128))
                         .astype(np.float32))
    calls = []
    real = tssm.mamba_ssd
    monkeypatch.setattr(tssm, "mamba_ssd", lambda *a, **k: calls.append(1) or real(*a, **k))
    plain, _ = tssm.mamba_fwd(tcfg, p, u)
    assert not calls
    kern, _ = tssm.mamba_fwd(tcfg.replace(attn_impl="pallas"), p, u)
    assert calls == [1]
    np.testing.assert_allclose(_np(kern), _np(plain), atol=F32_LAYER_ATOL)
    with pytest.raises(ValueError, match="attn_impl"):
        tssm.mamba_fwd(tcfg.replace(attn_impl="xla"), p, u)


def test_ssd_chunked_grads_stay_finite_past_exp_overflow():
    """At the full-width model's step sizes (dt = softplus(N(0, 0.55^2)),
    A = -1) a chunk of 128 decays by about 95, past f32's exp overflow at 88.
    ``repro``'s ``ssd_chunked`` masks its decay matrix after ``exp``, so its
    gradient is NaN there; the port's masks before ``exp``. Its gradients are
    held to autograd of the naive recurrence ``ref_ssd``, whose decays are
    all at most 1, within 1e-4 x max(1, max |g|)."""
    from repro_torch.kernels.ref import ref_ssd
    rng = np.random.default_rng(5)
    Bb, S, nh, hd, ds = 1, 128, 2, 8, 4
    x = rng.standard_normal((Bb, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(0.55 * rng.standard_normal((Bb, S, nh)))).astype(np.float32)
    A = -np.ones(nh, np.float32)
    B, C = (rng.standard_normal((Bb, S, nh, ds)).astype(np.float32) for _ in range(2))
    assert float((dt[0, :, 0] * A[0]).sum()) < -88

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        dtt = torch.from_numpy(dt).requires_grad_(True)
        y, h = fn(xt, dtt, torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C))
        return torch.autograd.grad(y.sum() + h.sum(), (xt, dtt))

    got = grads(lambda *a: tssm.ssd_chunked(*a, 128))
    ref = grads(ref_ssd)
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-4 * max(1.0, float(r.abs().max())))
    jax_dt = jax.grad(lambda d: jssm.ssd_chunked(jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(B),
                                                 jnp.asarray(C), 128)[0].sum())(jnp.asarray(dt))
    assert not bool(jnp.isfinite(jax_dt).all())


def test_prefill_on_cpu_launches_no_kernel():
    """On CPU tensors the scan runs the plain version: no launch."""
    jcfg, tcfg = _cfgs()
    _, tp = _weights(jcfg)
    before = ssd_mod.ssd_scan.launches
    tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(_tokens(tcfg, 1, 64))})
    assert ssd_mod.ssd_scan.launches == before


def test_decode_steps_match():
    """Three decode steps from an empty cache: logits and state agree."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    tokens = _tokens(jcfg, 2, 3, seed=6)
    jcache = jmodels.init_cache(jcfg, 2, 8)
    tcache = tmodel.init_cache(tcfg, 2, 8, "cpu")
    for i in range(3):
        lg_ref, jcache = jmodels.decode_step(jcfg, jp, jcache, jnp.asarray(tokens[:, i:i + 1]),
                                             jnp.asarray(i, jnp.int32))
        lg, tcache = tmodel.decode_step(tcfg, tp, tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=F32_MODEL_ATOL)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(tcache["layer0"][name]), _np(jcache["layer0"][name]),
                                   atol=F32_MODEL_ATOL)


def test_decode_matches_full_forward():
    """Decode logits at each position match the full forward's logits
    there (the JAX package's own SSM-state check, on the port)."""
    _, tcfg = _cfgs()
    _, tp = _weights(_cfgs()[0])
    B, S = 2, 8
    tokens = torch.from_numpy(_tokens(tcfg, B, S, seed=8))
    h, _, _ = tmodel.forward(tcfg, tp, {"tokens": tokens}, remat=False)
    full = tmodel._head(tcfg, tp, h)
    cache = tmodel.init_cache(tcfg, B, S + 1, "cpu")
    steps = []
    for t in range(S):
        lg, cache = tmodel.decode_step(tcfg, tp, cache, tokens[:, t:t + 1], t)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full),
                               atol=DECODE_VS_FORWARD_ATOL)


# ----------------------------------------------------------------- convert

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_a_mamba_tree(dtype):
    """``A_log``, ``dt_bias``, ``D_skip`` and ``conv_w`` in its (K, C) layout
    cross leaf by leaf, and the port's defs give the same tree."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _weights(jcfg)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert b.shape == a.shape, path
        np.testing.assert_array_equal(b, a.view(np.uint16) if dtype == "bfloat16" else a)
    mixer = _layer0(tp)["mixer"]
    assert tuple(mixer["conv_w"].shape) == (tcfg.ssm_conv, 288)
    own = tmodel.init_params(tcfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
