"""Port parity, models: ``repro_torch.models`` on the CPU against
``repro.models`` on reduced qwen2-1.5b, from the same weights.

The JAX package draws the parameters; ``repro_torch.models.convert`` carries
them over as numpy. Activations and tokens are drawn with numpy from a seed
and fed to both. Tolerances: f32 1e-4 on hidden states and logits (the two
frameworks sum in another order over 2 layers of width 192), 1e-5 on single
layers; bf16 5e-2 (bf16 rounds at other places in the two frameworks, and
its relative step is 2^-8).
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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_numpy, params_to_numpy

ARCH = "qwen2-1.5b"
CPU = torch.device("cpu")
F32_MODEL_ATOL = 1e-4
F32_LAYER_ATOL = 1e-5
BF16_ATOL = 5e-2


def _cfgs(dtype="float32", **kw):
    """The same reduced config in both packages."""
    return (jax_get_reduced(ARCH).replace(dtype=dtype, **kw),
            get_reduced(ARCH).replace(dtype=dtype, **kw))


def _weights(jcfg, seed=0):
    """JAX parameters and the port's copy of them on the CPU. The zero-init
    QKV biases get random values so that the bias path is exercised."""
    jp = jax.tree.map(np.asarray, jmodels.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    mixer = jp["blocks"]["layer0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        mixer[name] = (0.1 * rng.standard_normal(mixer[name].shape)).astype(mixer[name].dtype)
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


# ------------------------------------------------------------------ convert

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trips_the_jax_tree(dtype):
    jcfg, _ = _cfgs(dtype)
    jp, tp = _weights(jcfg)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert b.shape == a.shape, path
        if dtype == "bfloat16":
            assert b.dtype == np.uint16
            np.testing.assert_array_equal(b, a.view(np.uint16))
        else:
            np.testing.assert_array_equal(b, a)
    assert tp["embed"].dtype == getattr(torch, dtype)


def test_port_defs_match_jax_defs():
    """Same keys and shapes from ``init_params`` in both packages."""
    jcfg, tcfg = _cfgs()
    jp, _ = _weights(jcfg)
    tp = tmodel.init_params(tcfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert shapes_t == shapes_j


# ------------------------------------------------------------------- layers

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 192)).astype(np.float32)
    g = rng.standard_normal(192).astype(np.float32)
    ref = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)
    out = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)


def test_rotary_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 6, 32)).astype(np.float32)
    pos = np.arange(5, 21)
    ref = jlayers.rotary(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = tlayers.rotary(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)


def test_mlp_fwd_matches():
    jcfg, _ = _cfgs()
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 8, 192)).astype(np.float32)
    ref = jlayers.mlp_fwd(_layer0(jp)["ffn"], jnp.asarray(x))
    out = tlayers.mlp_fwd(_layer0(tp)["ffn"], torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("impl,chunk,window", [
    ("jnp", 1024, 0), ("jnp", 32, 0), ("jnp", 32, 48),
    ("pallas", 1024, 0), ("pallas", 1024, 48),
])
def test_attention_matches(impl, chunk, window):
    jcfg, tcfg = _cfgs(attn_impl=impl, attn_chunk=chunk, sliding_window=window)
    jp, tp = _weights(jcfg)
    S = 128
    x = np.random.default_rng(3).standard_normal((2, S, 192)).astype(np.float32)
    pos = np.arange(S)
    ref, (rk, rv) = jattn.attention(jcfg, _layer0(jp)["mixer"], jnp.asarray(x),
                                    jnp.asarray(pos))
    out, (k, v) = tattn.attention(tcfg, _layer0(tp)["mixer"], torch.from_numpy(x),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)
    np.testing.assert_allclose(_np(k), _np(rk), atol=F32_LAYER_ATOL)
    np.testing.assert_allclose(_np(v), _np(rv), atol=F32_LAYER_ATOL)


def test_attention_routes_agree_in_port():
    """``attn_impl="pallas"`` (the kernel's route) against ``"jnp"`` (the
    chunked plain path) inside the port, at the JAX test's tolerance 2e-3."""
    _, tcfg = _cfgs(attn_chunk=32)
    _, tp = _weights(_cfgs()[0])
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 128, 192))
                         .astype(np.float32))
    pos = torch.arange(128)
    a, _ = tattn.attention(tcfg, _layer0(tp)["mixer"], x, pos)
    b, _ = tattn.attention(tcfg.replace(attn_impl="pallas"), _layer0(tp)["mixer"], x, pos)
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-3)


@pytest.mark.parametrize("window,pos", [(0, 5), (0, 11), (8, 5), (8, 19)])
def test_decode_attention_matches(window, pos):
    """One token against a filled cache; with a window the cache is a ring of
    ``window`` slots, which wraps once ``pos`` passes it."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _weights(jcfg)
    rng = np.random.default_rng(5 + pos)
    Sc = window or 12
    kc = rng.standard_normal((2, Sc, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, Sc, 2, 32)).astype(np.float32)
    x = rng.standard_normal((2, 1, 192)).astype(np.float32)
    ref, rcache = jattn.decode_attention(
        jcfg, _layer0(jp)["mixer"], jnp.asarray(x),
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, pos)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, cache = tattn.decode_attention(tcfg, _layer0(tp)["mixer"], torch.from_numpy(x),
                                        cache, pos)
    np.testing.assert_allclose(_np(out), _np(ref), atol=F32_LAYER_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(rcache[name]), atol=F32_LAYER_ATOL)


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_forward_and_prefill_match(impl):
    jcfg, tcfg = _cfgs(attn_impl=impl)
    jp, tp = _weights(jcfg)
    tokens = _tokens(jcfg, 2, 128)
    h_ref, _, _ = jmodels.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)}, remat=False)
    h, _, _ = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)}, remat=False)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=F32_MODEL_ATOL)
    lg_ref = jmodels.prefill_step(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    lg = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert tuple(lg.shape) == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=F32_MODEL_ATOL)


def test_prefill_through_kernel_route_counts_no_cpu_launch():
    """On CPU tensors the kernel route runs the plain version: no launch."""
    _, tcfg = _cfgs(attn_impl="pallas")
    _, tp = _weights(_cfgs()[0])
    before = fa_mod.flash_attention.launches
    tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(_tokens(tcfg, 1, 64))})
    assert fa_mod.flash_attention.launches == before


def test_decode_steps_match():
    """Three decode steps from an empty cache: logits and cache agree."""
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
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["layer0"][name]), _np(jcache["layer0"][name]),
                                   atol=F32_MODEL_ATOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_bf16_prefill_matches(impl):
    jcfg, tcfg = _cfgs("bfloat16", attn_impl=impl)
    jp, tp = _weights(jcfg)
    tokens = _tokens(jcfg, 2, 64, seed=7)
    lg_ref = jmodels.prefill_step(jcfg, jp, {"tokens": jnp.asarray(tokens)})
    lg = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    assert lg.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=BF16_ATOL)
