"""Port parity, MoE and frontends: ``repro_torch.models.moe`` and the model
families built on it (olmoe, kimi, jamba) and on the frontend prefix
(musicgen, internvl) on the CPU against ``repro``, on reduced configs, from
the same weights and the same numpy inputs.

``moe_fwd`` is held to ``repro``'s in both combines, at capacity factors 0.5
(where assignments drop) and 1.25, in 1, 2 and 4 groups: the port's group
count comes from its axis rules over ``[cpu] * G``, ``repro``'s from
``moe.num_groups`` set to G (the rules change no value in ``repro``: they
pick G and place values). Its routing is held to ``repro``'s routing, step
by step as ``repro.models.moe.moe_fwd`` computes it: the chosen experts, the
capacity ranks (``_rank_within_expert``), ``keep``, and the slot tables
``idx`` and ``filled``.

Tolerances, f32 unless stated: routing exactly; y 1e-5, aux 1e-6, every
gradient 1e-5 x max(1, max |g|) (the two frameworks sum in another order);
bf16 5e-2, the bf16 tolerance of tests/test_torch_models.py. Whole models:
loss 1e-5 relative and every gradient 1e-4 x max(1, max |g|), the
tolerances of tests/test_torch_train.py; hidden states and prefill logits
1e-4, as tests/test_torch_models.py; greedy tokens equal. Jamba's Mamba
layers run at sequence 64 in chunks of 32, where ``repro``'s
``ssd_chunked`` keeps finite gradients (see test_torch_ssm.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import models as jmodels
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.launch.serve import generate as jax_generate
from repro.models import moe as jmoe
from repro.parallel.sharding import AxisRules as JaxAxisRules
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adam import leaves
from repro_torch.parallel.sharding import axis_rules

CPU = torch.device("cpu")
MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")
MODEL_ARCHS = ("olmoe-1b-7b", "jamba-v0.1-52b", "musicgen-large", "internvl2-26b")
B, S = 4, 16                          # moe_fwd inputs: 64 tokens
Y_ATOL, AUX_ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
BF16_ATOL = 5e-2
MODEL_BATCH, MODEL_SEQ = 2, 64
LOSS_RTOL, MODEL_GRAD_TOL, MODEL_ATOL = 1e-5, 1e-4, 1e-4


def _cfgs(arch, dtype="float32", **kw):
    """The same reduced config in both packages."""
    if arch.startswith("jamba"):
        kw.setdefault("ssm_chunk", 32)
    return (jax_get_reduced(arch).replace(dtype=dtype, **kw),
            get_reduced(arch).replace(dtype=dtype, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------------ moe_fwd

def _moe_inputs(cfg, seed=0):
    """One MoE layer's weights at unit-variance scales (the init's 0.02 gives
    a near-uniform router) and an input (B, S, D), as numpy f32."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    p = {"router": w(D, E, fan_in=D / 4), "w_gate": w(E, D, F, fan_in=D),
         "w_up": w(E, D, F, fan_in=D), "w_down": w(E, F, D, fan_in=F)}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


def _jax_routing(cfg, p, x, G):
    """``repro.models.moe.moe_fwd``'s routing in G groups, step by step."""
    E, K = cfg.num_experts, cfg.experts_per_token
    Tg = x.shape[0] * x.shape[1] // G
    C = jmoe.capacity(cfg, Tg)
    xt = x.reshape(G, Tg, -1)
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    _, e_idx = jax.lax.top_k(probs, K)
    pos = jax.vmap(jmoe._rank_within_expert, in_axes=(0, None))(e_idx, E)
    keep = pos < C
    safe_pos = jnp.where(keep, pos, C)
    token_id = jnp.broadcast_to(jnp.arange(Tg)[:, None], (Tg, K))

    def build_idx(eidx_g, pos_g):
        idx = jnp.zeros((E, C), jnp.int32).at[eidx_g, pos_g].set(token_id, mode="drop")
        filled = jnp.zeros((E, C), xt.dtype).at[eidx_g, pos_g].set(1.0, mode="drop")
        return idx, filled

    idx, filled = jax.vmap(build_idx)(e_idx, safe_pos)
    return dict(e_idx=e_idx, pos=pos, keep=keep, idx=idx, filled=filled)


def _port_rules(G):
    return tsteps.baseline_rules(tmesh.make_host_mesh([CPU] * G))


@functools.cache
def _jax_moe(arch, combine, cf, G, dtype="float32", grad=False):
    """``repro``'s y, aux and routing in G groups, and with ``grad`` the
    gradients of sum(y * cot) + aux with respect to the weights and x."""
    jcfg, _ = _cfgs(arch, dtype, capacity_factor=cf, moe_combine=combine)
    p, x = _moe_inputs(jcfg)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    dt = jnp.dtype(dtype)
    jp = {k: jnp.asarray(v, dt) for k, v in p.items()}

    def f(jp, jx):
        y, aux = jmoe.moe_fwd(jcfg, jp, jx)
        route = _jax_routing(jcfg, jp, jx, G)
        return jnp.sum(y.astype(jnp.float32) * cot) + aux, (y, aux, route)

    orig = jmoe.num_groups
    jmoe.num_groups = lambda total_tokens: G       # traced here, under jit
    try:
        if grad:
            (_, (y, aux, route)), grads = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x, dt))
            grads = jax.tree.map(_np, grads)
        else:
            _, (y, aux, route) = jax.jit(f)(jp, jnp.asarray(x, dt))
            grads = None
    finally:
        jmoe.num_groups = orig
    route = {k: np.asarray(v) for k, v in route.items()}
    return _np(y), float(aux), grads, route, p, x, cot


def _port_moe(arch, combine, cf, G, p, x, dtype="float32", grad=False):
    _, tcfg = _cfgs(arch, dtype, capacity_factor=cf, moe_combine=combine)
    dt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(dt).requires_grad_(grad) for k, v in p.items()}
    tx = torch.from_numpy(x).to(dt).requires_grad_(grad)
    with axis_rules(_port_rules(G)):
        y, aux = tmoe.moe_fwd(tcfg, tp, tx)
        _, r = tmoe.moe_layer(tcfg, tp, tx.detach())
    return y, aux, r, tp, tx


# olmoe in every combine, capacity factor and group count; kimi (whose
# reduced MoE layer has olmoe's shapes) and jamba (d_ff 128) in 2 groups
FWD_CASES = [("olmoe-1b-7b", c, cf, G) for c in ("gather", "scatter") for cf in (0.5, 1.25)
             for G in (1, 2, 4)] + [
    (a, c, cf, 2) for a in MOE_ARCHS[1:] for c in ("gather", "scatter") for cf in (0.5, 1.25)]


@pytest.mark.parametrize("arch,combine,cf,G", FWD_CASES)
def test_moe_fwd_and_drop_pattern_match_repro(arch, combine, cf, G):
    """Routing equal, y within 1e-5 and aux within 1e-6 of ``repro``'s."""
    ry, raux, _, rr, p, x, _ = _jax_moe(arch, combine, cf, G)
    y, aux, r, _, _ = _port_moe(arch, combine, cf, G, p, x)
    np.testing.assert_array_equal(r.e_idx.numpy(), rr["e_idx"])
    np.testing.assert_array_equal(r.pos.numpy(), rr["pos"])
    np.testing.assert_array_equal(r.keep.numpy(), rr["keep"])
    np.testing.assert_array_equal(r.idx.numpy(), rr["idx"])
    np.testing.assert_array_equal(r.filled.numpy(), rr["filled"])
    # the port's rank helper on repro's choices gives repro's ranks
    E = get_reduced(arch).num_experts
    np.testing.assert_array_equal(
        tmoe.rank_within_expert(torch.tensor(rr["e_idx"]).long(), E).numpy(), rr["pos"])
    if cf == 0.5:
        assert not rr["keep"].all(), "capacity factor 0.5 must drop assignments"
    np.testing.assert_allclose(_np(y), ry, rtol=0, atol=Y_ATOL)
    assert abs(float(aux) - raux) <= AUX_ATOL


@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grads_match_repro(arch, combine):
    """Gradients of sum(y * cot) + aux in 2 groups at capacity factor 0.5
    (assignments drop), with respect to every weight and x, against
    ``jax.grad``."""
    _, _, (rg, rgx), rr, p, x, cot = _jax_moe(arch, combine, 0.5, 2, grad=True)
    assert not rr["keep"].all()
    y, aux, _, tp, tx = _port_moe(arch, combine, 0.5, 2, p, x, grad=True)
    out = torch.sum(y * torch.from_numpy(cot)) + aux
    names = sorted(tp)
    grads = torch.autograd.grad(out, [tp[k] for k in names] + [tx])
    for name, g in zip([*names, "x"], grads, strict=True):
        want = rgx if name == "x" else rg[name]
        tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(_np(g), want, rtol=0, atol=tol, err_msg=name)


def test_moe_fwd_bf16_matches_repro():
    ry, raux, _, _, p, x, _ = _jax_moe("olmoe-1b-7b", "gather", 1.25, 2, "bfloat16")
    y, aux, _, _, _ = _port_moe("olmoe-1b-7b", "gather", 1.25, 2, p, x, "bfloat16")
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), ry, rtol=0, atol=BF16_ATOL)
    assert abs(float(aux) - raux) <= BF16_ATOL


def test_routing_context_sets_groups_and_collects_stats():
    """``moe.routing`` overrides the rules' group count inside a stack, and
    ``loss_fn`` returns each MoE layer's statistics; outside it the rules
    decide."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    params = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.long),
             "labels": torch.zeros((4, 8), dtype=torch.long)}
    with tmoe.routing(2):
        assert tmoe.stack_groups(32) == 2
        _, metrics = tmodel.loss_fn(tcfg, params, batch, remat=False)
    stats = metrics["moe"]
    assert len(stats) == tcfg.num_layers
    assert all(d.shape == (tcfg.num_experts,) and not d.requires_grad for d, _ in stats)
    aux = sum(tmoe.aux_loss(d, mp) for d, mp in stats)
    assert torch.allclose(aux, metrics["aux"])
    with axis_rules(_port_rules(4)):
        assert tmoe.stack_groups(32) == 4
        assert tmoe.stack_groups(30) == 1
        with tmoe.routing(1):
            assert tmoe.stack_groups(32) == 1
    assert tmoe.stack_groups(32) == 1


# --------------------------------------------------------------- model zoo

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds(arch):
    """``model_defs`` builds for every arch at full size with ``repro``'s
    parameter shapes (on the meta device), and the reduced config's too."""
    assert arch in JAX_ARCH_IDS
    full = jax.tree.map(lambda s: tuple(s.shape),
                        jmodels.abstract_params(jax_get_config(arch)))
    assert jax.tree.map(lambda t: tuple(t.shape),
                        tmodel.abstract_params(get_config(arch))) == full
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree.map(lambda s: tuple(s.shape), jmodels.abstract_params(jcfg))
    got = jax.tree.map(lambda t: tuple(t.shape), tmodel.abstract_params(tcfg))
    assert got == want


def _batch(cfg, seed=3, rows=MODEL_BATCH, seq=MODEL_SEQ):
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (rows, seq)) for k in ("tokens", "labels")}
    if cfg.frontend != "none":
        out["prefix"] = rng.standard_normal((rows, cfg.frontend_tokens, cfg.d_model)) \
            .astype(np.float32)
    return out


@functools.cache
def _model(arch):
    """Reduced f32 configs, ``repro``'s parameters as numpy, one batch, and
    ``repro``'s loss and gradients (``loss_chunk`` 16)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jax.jit(jmodels.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    batch = _batch(jcfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: jmodels.loss_fn(jcfg, p, b, loss_chunk=16)[0]))
    loss, grads = f(jax.tree.map(jnp.asarray, jp),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, tcfg, jp, batch, float(loss), jax.tree.map(np.asarray, grads)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_loss_and_grads_match_repro(arch, policy):
    _, tcfg, jp, batch, ref_loss, ref_grads = _model(arch)
    tp = params_from_numpy(jp, CPU)
    ps = leaves(tp)
    for p in ps:
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(tcfg, tp, _torch_batch(batch), loss_chunk=16,
                                   remat_policy=policy)
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=LOSS_RTOL)
    if tcfg.num_experts:
        assert float(metrics["aux"].detach()) > 0
    grads = dict(zip(_flat(tp), (_np(g) for g in torch.autograd.grad(loss, ps)), strict=True))
    ref = _flat(ref_grads)
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        tol = MODEL_GRAD_TOL * max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g, ref[name], rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_forward_and_prefill_match_repro(arch, impl):
    jcfg, tcfg, jp, batch, _, _ = _model(arch)
    jcfg, tcfg = jcfg.replace(attn_impl=impl), tcfg.replace(attn_impl=impl)
    tp = params_from_numpy(jp, CPU)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    tb = {k: v for k, v in _torch_batch(batch).items() if k != "labels"}
    h_ref, lg_ref = jax.jit(lambda p, b: (jmodels.forward(jcfg, p, b, remat=False)[0],
                                          jmodels.prefill_step(jcfg, p, b)))(jp, jb)
    h, _, n = tmodel.forward(tcfg, tp, tb, remat=False)
    assert n == (tcfg.frontend_tokens if tcfg.frontend != "none" else 0)
    np.testing.assert_allclose(_np(h), _np(h_ref), atol=MODEL_ATOL)
    lg = tmodel.prefill_step(tcfg, tp, tb)
    assert tuple(lg.shape) == (MODEL_BATCH, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(lg), _np(lg_ref), atol=MODEL_ATOL)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_generate_gives_repro_tokens(arch):
    jcfg, tcfg, jp, batch, _, _ = _model(arch)
    prompts = batch["tokens"][:, :6]
    ref = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts, jnp.int32), 6,
                                  JaxAxisRules(), prefix=batch.get("prefix")))
    out = tserve.generate(tcfg, params_from_numpy(jp, CPU), prompts, 6,
                          prefix=batch.get("prefix"))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_input_specs_match_repro():
    """Frontend configs: the prefix takes ``frontend_tokens`` of the
    sequence, in the model's dtype, as in ``repro``."""
    from repro.configs.shapes import InputShape as JaxShape
    from repro_torch.configs.shapes import InputShape
    for arch in ("musicgen-large", "internvl2-26b", "olmoe-1b-7b"):
        for kind in ("train", "prefill", "decode"):
            want = jmodels.input_specs(jax_get_reduced(arch), JaxShape("s", 32, 2, kind))
            got = tmodel.input_specs(get_reduced(arch), InputShape("s", 32, 2, kind))
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}, (arch, kind)
            assert all(v.is_meta for v in got.values())
