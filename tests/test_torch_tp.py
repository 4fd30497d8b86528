"""Port parity, tensor parallelism over a ``"model"`` axis:
``repro_torch``'s steps under ``baseline_rules`` on a ``("data", "model")``
mesh against ``repro``'s, on reduced configs in f32.

``repro`` runs in one subprocess an arch, all started together, with four
forced host devices: under ``baseline_rules(make_mesh((2, 2), ("data",
"model")))`` it takes the loss and ``jax.grad`` of ``loss_fn`` (inside
``axis_rules``), the jitted prefill step's logits, and ``generate``'s
tokens, and passes them back as an ``.npz``. The port takes the same
parameters (``models.convert.params_from_numpy``) and numpy batches, lays
them out with ``parallel.tensor.shard_params`` over ``[cpu] * 4``, and runs
``make_grad_step``, ``make_prefill_step`` and ``serve.generate`` under the
same rules. mamba2-130m's mixer splits by heads on every mesh. Two more
cases run on a ``(1, 4)`` mesh: reduced qwen2-1.5b with 8 query heads on
its 2 KV heads (the KV heads do not divide: each position attends with
its group's), and reduced qwen2-1.5b itself, whose 6 query heads do not
divide either (two groups of 3, each attended by the 2 positions that
hold its columns). On the ``(1, 4)`` mesh every model runs split; the
collective counter shows the gathers, and the port is held to its own
one-device step under the same rules. Rules that replicate a leaf a split
needs make that layer run gathered, held to one device too. The other
seven reduced configs run on both meshes against one device.
``test_layout_follows_repro_logical_spec`` holds every config's modes and
shard shapes to ``repro``'s ``logical_spec``.

Tolerances, f32: losses 1e-4 x |loss|; each gradient leaf 1e-4 x max |b|
(the shards sum in another order than one device); prefill logits 1e-4;
generated tokens equal. olmoe routes every token alike here; a token whose
top-k differed would have to be a near-tie (``chip_smoke.py``'s route
gate), and none occurs at these inputs, so the tokens are held equal. Four
``make_train_step`` steps over the (2, 2) mesh track one device's losses
within 1e-4 and each gathered parameter within ``PARAM_TOL[lr]`` x max(1,
max |p|): AdamW's first step maps a gradient element below ``eps`` = 1e-8 to
lr * g / eps, so it multiplies the gradients' f32 summation-order
differences (about 1e-10) by lr / eps: up to 3e-5 at lr 1e-3, 3e-6 at 1e-4.

Mamba runs at sequence 64 in chunks of 32, where ``repro``'s
``ssd_chunked`` keeps finite gradients (see test_torch_ssm.py).
"""
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import abstract_params, init_params
from repro_torch.optim.adam import AdamW, leaves
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import AxisRules, axis_rules, logical_shard

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "mamba2-130m")
# on a (1, 4) mesh: reduced qwen2-1.5b with 8 query heads on its 2 KV heads,
# and reduced qwen2-1.5b (6 query heads: 2 groups of 3, each on 2 positions)
GROUPED, HEAD_GROUPS = "qwen2-1.5b-h8", "qwen2-1.5b-1x4"
MESH = {GROUPED: (1, 4), HEAD_GROUPS: (1, 4)}
SEQ = {"qwen2-1.5b": 32, "mamba2-130m": 64, "olmoe-1b-7b": 32, GROUPED: 32, HEAD_GROUPS: 32}
ROWS, PROMPT, GEN, TOL = 4, 16, 6, 1e-4
STEPS = 4
PARAM_TOL = {1e-4: 1e-5, 1e-3: 1e-4}


def _overrides(case) -> tuple:
    """(arch, the reduced config's overrides) of a ``repro`` case."""
    if case == GROUPED:
        return "qwen2-1.5b", {"dtype": "float32", "num_heads": 8, "num_kv_heads": 2}
    if case == HEAD_GROUPS:
        return "qwen2-1.5b", {"dtype": "float32"}
    kw = {"ssm_chunk": 32} if case == "mamba2-130m" else {}
    return case, {"dtype": "float32", **kw}


def _cfg(case):
    arch, kw = _overrides(case)
    return get_reduced(arch).replace(**kw)


def _batch(vocab: int, rows: int, seq: int, step: int) -> dict:
    rng = np.random.default_rng(1000 + 10 * rows + step)
    return {k: rng.integers(0, vocab, (rows, seq)).astype(np.int32) for k in ("tokens", "labels")}


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(0, vocab, (ROWS, PROMPT)).astype(np.int32)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


_JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch.serve import generate
from repro.models import init_params, loss_fn
from repro.parallel.sharding import axis_rules
sys.path.insert(0, {test_dir!r})
from test_torch_tp import GEN, MESH, ROWS, SEQ, _batch, _flatten, _overrides, _prompts

assert len(jax.devices()) == 4, jax.devices()
out, case = sys.argv[1], sys.argv[2]
arch, kw = _overrides(case)
cfg = get_reduced(arch).replace(**kw)
params = init_params(cfg, jax.random.PRNGKey(0))
res = {{f"init/{{k}}": np.asarray(v) for k, v in _flatten(params).items()}}
rules = jsteps.baseline_rules(jmesh.make_mesh(MESH.get(case, (2, 2)), ("data", "model")))

def loss(p, b):
    with axis_rules(rules):
        return loss_fn(cfg, p, b, remat=False)[0]

batch = jax.tree.map(jnp.asarray, _batch(cfg.vocab_size, ROWS, SEQ[case], 0))
l, g = jax.jit(jax.value_and_grad(loss))(params, batch)
res["loss"] = np.float64(l)
for k, v in _flatten(g).items():
    res[f"grad/{{k}}"] = np.asarray(v)
prompts = jnp.asarray(_prompts(cfg.vocab_size))
res["prefill"] = np.asarray(jax.jit(jsteps.make_prefill_step(cfg, rules))(
    params, {{"tokens": prompts}}))
res["tokens"] = np.asarray(generate(cfg, params, prompts, GEN, rules))
np.savez(out, **res)
print("JAX_TP_OK")
"""


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """``repro``'s loss, gradients, prefill logits and tokens under the
    (2, 2) rules (``MESH``'s cases: (1, 4)): one subprocess a case, all
    started together."""
    tmp = tmp_path_factory.mktemp("jaxtp")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_SCRIPT.format(
        test_dir=os.path.dirname(os.path.abspath(__file__))))
    outs = {a: str(tmp / f"{a}.npz") for a in (*ARCHS, *MESH)}
    procs = {a: subprocess.Popen([sys.executable, "-c", code, out, a], env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a, out in outs.items()}
    res = {}
    for a, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "JAX_TP_OK" in stdout, stderr[-3000:]
        with np.load(outs[a]) as f:
            res[a] = {k: f[k] for k in f.files}
    return res


def _rules(shape):
    return tsteps.baseline_rules(tmesh.make_mesh(shape, ("data", "model"), [CPU] * 4))


def _params(ref):
    return params_from_numpy(_unflatten({k[5:]: v for k, v in ref.items()
                                         if k.startswith("init/")}), CPU)


def _torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _close_grads(got, want, what):
    for k, w in _flatten(want).items():
        g = _flatten(got)[k]
        w = w if isinstance(w, np.ndarray) else w.detach().numpy()
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=TOL * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{what} {k}")


# ------------------------------------------------------------- gradients

@pytest.mark.parametrize("arch", ARCHS)
def test_tp_grads_match_repro(jax_tp, arch):
    """Loss and every gradient leaf of ``make_grad_step`` over the (2, 2)
    mesh against ``jax.grad`` of ``repro``'s ``loss_fn`` under the same
    rules."""
    ref, cfg = jax_tp[arch], _cfg(arch)
    rules = _rules((2, 2))
    lay = tp.layout(cfg, rules)
    shards = tp.shard_params(cfg, _params(ref), rules)
    with tp.collectives() as coll:
        loss, _, grads = tsteps.make_grad_step(cfg, rules)(
            shards, _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[arch], 0)))
    want = float(ref["loss"])
    assert abs(float(loss) - want) <= TOL * abs(want)
    full = tp.gather_params(cfg, grads, rules)
    _close_grads(full, {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}, arch)
    # each row's attention or SSM mixer and FFN partial sums went through
    # reduce_partial; every mixer split, mamba's by heads
    assert coll.of(0)["all-reduce"][0] > 0
    assert lay.modes["layer0/mixer"] == "split"


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_one_by_four_matches_one_device(arch):
    """Over a (1, 4) mesh every mixer splits. Reduced qwen2-1.5b's 6 query
    heads do not divide over 4 positions: they attend in 2 groups of 3,
    each on the 2 positions that hold its columns, from q's and K's and V's
    columns gathered. mamba's mixer splits by heads and gathers only the
    convolved ``B|C``. Each gather runs once a layer and again in the
    checkpointed recompute, beside the logits'. Loss and gradients equal
    one device's under the same rules."""
    cfg = _cfg(arch)
    rules = _rules((1, 4))
    lay = tp.layout(cfg, rules)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[arch], 1))
    with axis_rules(rules):
        l1, m1, g1 = tsteps.make_grad_step(cfg, None)(params, batch)
    for t in leaves(params):
        t.requires_grad_(False)
    with tp.collectives() as coll:
        ln, mn, gn = tsteps.make_grad_step(cfg, rules)(tp.shard_params(cfg, params, rules),
                                                       batch)
    assert lay.modes["layer0/mixer"] == "split"
    # the activations a split mixer gathers, a layer: q, K and V (qwen2),
    # B|C (mamba), none (olmoe: whole heads in whole KV groups)
    per_layer = {"qwen2-1.5b": 3, "mamba2-130m": 1, "olmoe-1b-7b": 0}[arch]
    n_gathers = coll.of(0).get("all-gather", (0, 0))[0]
    # ... and the MoE router's logits a layer (olmoe: every layer), each in
    # the recompute too
    n_moe = cfg.num_layers if cfg.num_experts else 0
    assert n_gathers == 2 * (per_layer * cfg.num_layers + n_moe) + 1, n_gathers
    if arch == "qwen2-1.5b":
        assert "each group's on 2 positions" in tp.describe(lay)
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    assert abs(float(mn["aux"]) - float(m1["aux"])) <= TOL * max(1.0, abs(float(m1["aux"])))
    _close_grads(tp.gather_params(cfg, gn, rules), g1, arch)


@pytest.mark.parametrize("arch,override", [("qwen2-1.5b", "kv_heads"),
                                           ("mamba2-130m", "ssm_heads")])
def test_tp_gathered_layers_match_one_device(arch, override):
    """Rules that replicate a leaf a mixer's split needs (``override`` off
    ``"model"``: qwen2's ``wk``/``wv``, mamba's per-head leaves and SSM
    state) make the mixer run gathered over the (1, 4) mesh: each position
    gathers the leaves still split, computes the whole layer and, in the
    decode step, gathers the split cache leaves and writes its slice back.
    Loss, gradients, prefill logits and ``generate``'s tokens equal one
    device's under the same rules."""
    from repro_torch.launch.serve import generate
    cfg = _cfg(arch)
    rules = tsteps.baseline_rules(tmesh.make_mesh((1, 4), ("data", "model"), [CPU] * 4),
                                  overrides={override: None})
    lay = tp.layout(cfg, rules)
    assert lay.modes["layer0/mixer"] == "gathered" and "layer0/mixer" in tp.describe(lay)
    params = init_params(cfg, torch.Generator().manual_seed(4), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[arch], 4))
    with axis_rules(rules):
        l1, _, g1 = tsteps.make_grad_step(cfg, None)(params, batch)
    for t in leaves(params):
        t.requires_grad_(False)
    with axis_rules(rules):
        want = tsteps.make_prefill_step(cfg, None)(params, {"tokens": batch["tokens"]})
        toks = generate(cfg, params, _prompts(cfg.vocab_size), GEN)
    shards = tp.shard_params(cfg, params, rules)
    with tp.collectives() as coll:
        ln, _, gn = tsteps.make_grad_step(cfg, rules)(shards, batch)
    n_split = sum(d is not None for d in lay.period_dims["layer0"]["mixer"].values())
    assert n_split and coll.of(0)["all-gather"][0] >= n_split * cfg.num_layers
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    _close_grads(tp.gather_params(cfg, gn, rules), g1, arch)
    got = tsteps.make_prefill_step(cfg, rules)(shards, {"tokens": batch["tokens"]})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    assert torch.equal(generate(cfg, params, _prompts(cfg.vocab_size), GEN, rules), toks)


OTHER_ARCHS = ("yi-6b", "deepseek-7b", "minitron-4b", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
               "musicgen-large", "internvl2-26b")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", OTHER_ARCHS)
def test_tp_every_family_matches_one_device(arch, shape):
    """Every other reduced config (dense, MoE, the jamba hybrid, the prefix
    models with their frontend's embeddings) over both meshes against one
    device under the same rules: loss and gradients 1e-4, prefill logits
    1e-4, ``generate``'s tokens equal."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import input_specs
    kw = {"ssm_chunk": 32} if arch == "jamba-v0.1-52b" else {}
    cfg = get_reduced(arch).replace(dtype="float32", **kw)
    rules = _rules(shape)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(3)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, tuple(v.shape)))
             if v.dtype == torch.long else
             torch.as_tensor(rng.standard_normal(tuple(v.shape)), dtype=torch.float32)
             for k, v in input_specs(cfg, InputShape("t", 64, ROWS, "train")).items()}
    with axis_rules(rules):
        l1, _, g1 = tsteps.make_grad_step(cfg, None)(params, batch)
    for t in leaves(params):
        t.requires_grad_(False)
    shards = tp.shard_params(cfg, params, rules)
    ln, _, gn = tsteps.make_grad_step(cfg, rules)(shards, batch)
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    _close_grads(tp.gather_params(cfg, gn, rules), g1, arch)
    served = {k: v for k, v in batch.items() if k != "labels"}
    with axis_rules(rules):
        want = tsteps.make_prefill_step(cfg, None)(params, served)
        toks = generate(cfg, params, _prompts(cfg.vocab_size), GEN)
    got = tsteps.make_prefill_step(cfg, rules)(shards, served)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    assert torch.equal(generate(cfg, params, _prompts(cfg.vocab_size), GEN, rules), toks)


@pytest.mark.parametrize("options", [
    {"loss_chunk": 8}, {"remat_policy": "dots"}, {"remat_policy": "none"},
    {"remat": False, "loss_chunk": 16}], ids=["chunk8", "dots", "none", "noremat-chunk16"])
def test_tp_step_options_match_one_device(options):
    """``StepOptions`` under tensor parallelism: the CE in checkpointed
    chunks of gathered logits, and each remat policy over the whole
    period of positions, against one device with the same options."""
    cfg = _cfg("qwen2-1.5b")
    rules = _rules((2, 2))
    opts = tsteps.StepOptions(**options)
    params = init_params(cfg, torch.Generator().manual_seed(2), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ["qwen2-1.5b"], 2))
    with axis_rules(rules):
        l1, _, g1 = tsteps.make_grad_step(cfg, None, opts)(params, batch)
    for t in leaves(params):
        t.requires_grad_(False)
    ln, _, gn = tsteps.make_grad_step(cfg, rules, opts)(tp.shard_params(cfg, params, rules),
                                                        batch)
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    _close_grads(tp.gather_params(cfg, gn, rules), g1, str(options))


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_generate_match_repro(jax_tp, arch):
    """The prefill step's logits and ``generate``'s tokens over the (2, 2)
    mesh against ``repro``'s under the same rules: the KV and SSM caches
    laid out by ``cache_shardings`` (``kv_heads``, ``ssm_heads``,
    ``ssm_inner`` on ``"model"``), mamba's gathered around each step."""
    from repro_torch.launch.serve import generate
    ref, cfg = jax_tp[arch], _cfg(arch)
    rules = _rules((2, 2))
    params = _params(ref)
    prompts = _prompts(cfg.vocab_size)
    logits = tsteps.make_prefill_step(cfg, rules)(
        tp.shard_params(cfg, params, rules), {"tokens": torch.as_tensor(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], rtol=0, atol=TOL)
    toks = generate(cfg, params, prompts, GEN, rules)
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])


@pytest.mark.parametrize("case", [GROUPED, HEAD_GROUPS])
def test_tp_grouped_kv_heads_match_repro(jax_tp, case):
    """Attention over a (1, 4) mesh where ``repro`` splits ``wq``, ``wk``,
    ``wv`` and ``wo`` but not the heads. 8 query heads on 2 KV heads: each
    position attends with 2 query heads and the KV head of their group
    (positions 0-1 head 0, 2-3 head 1), from the K and V columns
    all-gathered. Reduced qwen2-1.5b's 6 query heads: 2 groups of 3, each
    attended by both positions that hold its columns, from q's columns
    gathered too; each position's ``wo`` rows take its columns of its
    group's output. Loss, every gradient leaf, the prefill logits and
    ``generate``'s tokens against ``repro``'s."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention as tattn
    ref, cfg = jax_tp[case], _cfg(case)
    rules = _rules(MESH[case])
    lay = tp.layout(cfg, rules)
    assert lay.modes["layer0/mixer"] == "split" and "KV heads by group" in tp.describe(lay)
    shards4 = [tattn.head_shard(cfg, 4, j) for j in range(4)]
    assert [s.kv for s in shards4] == [slice(0, 1)] * 2 + [slice(1, 2)] * 2
    assert all((s.q is None) == (case == GROUPED) for s in shards4)
    params = _params(ref)
    shards = tp.shard_params(cfg, params, rules)
    with tp.collectives() as coll:
        loss, _, grads = tsteps.make_grad_step(cfg, rules)(
            shards, _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[case], 0)))
    want = float(ref["loss"])
    assert abs(float(loss) - want) <= TOL * abs(want)
    _close_grads(tp.gather_params(cfg, grads, rules),
                 {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}, case)
    # (q,) K and V columns gathered in each layer, again in the recompute,
    # and the logits
    per_layer = 2 if case == GROUPED else 3
    assert coll.of(0)["all-gather"][0] == 2 * per_layer * cfg.num_layers + 1
    prompts = _prompts(cfg.vocab_size)
    logits = tsteps.make_prefill_step(cfg, rules)(
        shards, {"tokens": torch.as_tensor(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], rtol=0, atol=TOL)
    toks = generate(cfg, params, prompts, GEN, rules)
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])


# ----------------------------------------------------------- train step

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


@pytest.mark.parametrize("lr", sorted(PARAM_TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_step_tracks_one_device(arch, lr):
    """Four ``make_train_step`` steps over the (2, 2) mesh, AdamW on every
    shard (moments laid out by ``shard_state``), against one device's under
    the same rules: each step's loss and grad_norm, and every parameter
    gathered from its shards."""
    cfg = _cfg(arch)
    rules = _rules((2, 2))
    p0 = init_params(cfg, torch.Generator().manual_seed(1), CPU)
    opt = AdamW(lr=lr)
    one = _clone(p0)
    state = opt.init(one)
    full = _clone(p0)
    shards = tp.shard_params(cfg, full, rules)
    tstate = tp.shard_state(cfg, opt.init(full), rules)
    step1, stepn = tsteps.make_train_step(cfg, opt, None), tsteps.make_train_step(cfg, opt, rules)
    for step in range(STEPS):
        batch = _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[arch], step))
        with axis_rules(rules):
            one, state, m1 = step1(one, state, step, batch)
        shards, tstate, mn = stepn(shards, tstate, step, batch)
        for k in ("loss", "grad_norm"):
            assert abs(float(mn[k]) - float(m1[k])) <= TOL * abs(float(m1[k])), (step, k)
        got = _flatten(tp.gather_params(cfg, shards, rules))
        for k, w in _flatten(one).items():
            np.testing.assert_allclose(got[k].numpy(), w.detach().numpy(), rtol=0,
                                       atol=PARAM_TOL[lr] * max(1.0, w.abs().max().item()),
                                       err_msg=f"step {step} {k}")


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("m", [2, 4, 8])
def test_layout_of_full_width_configs(m):
    """Which layers run split at full width on ``m`` positions of
    ``"model"``: qwen2-1.5b's attention (12 heads, 2 KV heads) always: at
    m = 4 and 8 each KV head replicated over its group's positions, at 8
    its 12 query heads in 4 groups of 3, each on 2 positions; its MLP and
    vocabulary always; mamba2-130m's and jamba's Mamba-2 mixers always;
    olmoe's attention and experts always. On ``meta``: nothing is
    allocated."""
    mesh = tmesh.make_mesh((1, m), ("data", "model"), [torch.device("meta")] * m)
    rules = tsteps.baseline_rules(mesh)
    qwen = tp.layout(get_config("qwen2-1.5b"), rules)
    assert qwen.modes["layer0/mixer"] == "split"
    assert ("KV heads by group" in tp.describe(qwen)) == (m > 2)
    assert ("each group's on 2 positions" in tp.describe(qwen)) == (m == 8)
    assert qwen.modes["layer0/ffn"] == "split"
    assert qwen.modes["embed"] == qwen.modes["head"] == "split"
    mamba = tp.layout(get_config("mamba2-130m"), rules)
    assert mamba.modes["layer0/mixer"] == "split"
    jamba = tp.layout(get_config("jamba-v0.1-52b"), rules)
    assert all(jamba.modes[f"layer{j}/mixer"] == "split" for j in range(8))
    olmoe = tp.layout(get_config("olmoe-1b-7b"), rules)
    assert olmoe.modes["layer0/mixer"] == olmoe.modes["layer0/ffn"] == "split"
    assert "gathered: none" in tp.describe(qwen)


_SPLIT_DIMS = {  # the dim that a split unit needs on "model", of a leaf of one period
    "attention": {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0},
    "mamba": {"in_proj": 1, "conv_w": 1, "conv_b": 0, "A_log": 0, "dt_bias": 0, "D_skip": 0,
              "norm": 0, "out_proj": 0},
    "mlp": {"w_gate": 1, "w_up": 1, "w_down": 0},
    "moe": {"router": 1, "w_gate": 0, "w_up": 0, "w_down": 0},
}


def _repro_layout(jcfg, m: int):
    """From ``repro``'s ``baseline_rules`` and ``logical_spec`` on a (1, m)
    mesh: the modes a unit should run in (split where ``logical_spec`` puts
    every leaf the split needs on ``"model"``), and each leaf's shape on
    one device."""
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    from repro.parallel import sharding as jsh

    class Fake:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": m}
    rules = jsteps.baseline_rules(Fake())

    def spec(ax, shape):
        with jsh.axis_rules(rules):
            return tuple(jsh.logical_spec(ax, shape=tuple(shape)))

    def on(ax, t, dim):
        sp = spec(ax, t.shape)
        return dim < len(sp) and sp[dim] == "model"

    def unit(ax, t, want, stacked=1):
        return all(on(ax[k], t[k], d + stacked) for k, d in want.items() if k in ax)
    axes, abstract = jmodel.param_axes(jcfg), jmodel.abstract_params(jcfg)
    modes = {}
    for j, ch in enumerate(jcfg.pattern):
        la, lt = axes["blocks"][f"layer{j}"], abstract["blocks"][f"layer{j}"]
        split = unit(la["mixer"], lt["mixer"], _SPLIT_DIMS["attention" if ch == "A" else "mamba"])
        modes[f"layer{j}/mixer"] = "split" if split else "gathered"
        if jcfg.d_ff > 0:
            kind = "moe" if "router" in la["ffn"] else "mlp"
            split = unit(la["ffn"], lt["ffn"], _SPLIT_DIMS[kind])
            modes[f"layer{j}/ffn"] = "split" if split else "gathered"
    modes["embed"] = "split" if on(axes["embed"], abstract["embed"], 0) else "gathered"
    head = (on(axes["embed"], abstract["embed"], 0) if jcfg.tie_embeddings
            else on(axes["head"], abstract["head"], 1))
    modes["head"] = "split" if head else "gathered"
    shapes = {}
    for k, ax in _flatten(axes).items():
        shape = list(_flatten(abstract)[k].shape)
        for d, e in enumerate(spec(ax, shape)):
            if e == "model":
                shape[d] //= m
        shapes[k] = tuple(shape)
    return modes, shapes


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_follows_repro_logical_spec(arch, size, m):
    """Every config of ``configs/``, full and reduced, on ``m`` positions of
    ``"model"``: ``layout().modes`` is "gathered" exactly where ``repro``'s
    ``logical_spec`` replicates a dim that the unit's split needs, and each
    position's shard of every leaf (``shard_params`` on ``meta``) has
    ``repro``'s shape on one device, so a position holds ``repro``'s
    parameter bytes. No config puts a group of query heads across part of
    two KV groups, the case ``attention.head_shard`` refuses."""
    import repro.configs as jconfigs
    from repro_torch.models import attention as tattn
    get = get_config if size == "full" else get_reduced
    cfg = get(arch)
    jcfg = (jconfigs.get_config if size == "full" else jconfigs.get_reduced)(arch)
    mesh = tmesh.make_mesh((1, m), ("data", "model"), [torch.device("meta")] * m)
    rules = tsteps.baseline_rules(mesh)
    lay = tp.layout(cfg, rules)
    want, shapes = _repro_layout(jcfg, m)
    assert lay.modes == want
    if "A" in cfg.pattern:
        heads = {tattn.head_shard(cfg, m, j).cfg.num_heads for j in range(m)}
        assert heads == {cfg.num_heads // math.gcd(cfg.num_heads, m)}
    shards = tp.shard_params(cfg, abstract_params(cfg), rules)
    for p in (0, m - 1):
        got = {k: tuple(t.shape) for k, t in _flatten(shards[p]).items()}
        assert got == shapes, p


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_and_gather_round_trip(arch):
    """``shard_params``: every split leaf in equal, contiguous slices that
    are views of the leaf on the same device, every other leaf the leaf
    itself, except a split Mamba-2 mixer's packed leaves: position ``j``'s
    ``in_proj`` holds the ``j``-th ``1 / m`` of each of ``z``, ``x``,
    ``B|C`` and ``dt``'s columns, its ``conv_w``/``conv_b`` the same of
    ``x`` and ``B|C``'s channels. ``gather_params`` returns the tree bit for
    bit."""
    cfg = _cfg(arch)
    rules = _rules((2, 2))
    lay = tp.layout(cfg, rules)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    shards = tp.shard_params(cfg, params, rules)
    assert len(shards) == 4
    di, ds, g, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    packed = {"in_proj": (di, di, 2 * g * ds, nh), "conv_w": (di, 2 * g * ds),
              "conv_b": (di, 2 * g * ds)}
    n_packed = 0
    for p, tree in enumerate(shards):
        j = p % lay.m
        for (k, t), (_, whole), d in zip(_flatten(tree).items(), _flatten(params).items(),
                                          leaves(lay.dims), strict=True):
            name = k.split(".")[-1]
            if d is None:
                assert t is whole, k
            elif ".mixer." in k and cfg.family == "ssm" and name in packed:
                # the j-th 1/m of each segment, in order: a copy
                cuts, off = [], 0
                for n in packed[name]:
                    cuts.append(whole.narrow(d, off + j * (n // lay.m), n // lay.m))
                    off += n
                assert torch.equal(t, torch.cat(cuts, d)), k
                assert t.shape[d] * lay.m == whole.shape[d], k
                n_packed += 1
            else:
                w = whole.shape[d] // lay.m
                assert t.shape[d] == w and t.untyped_storage().data_ptr() == \
                    whole.untyped_storage().data_ptr(), k
                assert torch.equal(t, whole.narrow(d, j * w, w)), k
    assert n_packed == (3 * 4 if cfg.family == "ssm" else 0)
    back = tp.gather_params(cfg, shards, rules)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(params), strict=True))


def test_cache_shards_follow_cache_shardings():
    """``init_cache_shards`` splits the leaves ``cache_shardings`` puts on
    ``"model"``: qwen's ``kv_heads``, mamba's ``ssm_heads`` and
    ``ssm_inner``."""
    for arch in ("qwen2-1.5b", "mamba2-130m"):
        cfg = _cfg(arch)
        rules = _rules((2, 2))
        lay = tp.layout(cfg, rules)
        cs = tsteps.cache_shardings(cfg, InputShape("g", 16, ROWS, "decode"), rules)
        shards = tp.init_cache_shards(lay, ROWS // 2, 16)
        full = tsteps.model_mod.cache_specs(cfg, ROWS // 2, 16)
        for (k, t), (_, s), (_, f) in zip(_flatten(shards[0]).items(), _flatten(cs).items(),
                                          _flatten(full).items(), strict=True):
            split = [i for i, e in enumerate(s.spec) if e == "model"]
            want = list(f.shape)
            for i in split:
                want[i] //= 2
            assert list(t.shape) == want, (arch, k)
        assert any("model" in s.spec for s in leaves(cs))


def test_jit_builders_return_repro_tuples():
    """``jit_train_step``, ``jit_serve_step`` and ``jit_prefill_step``: the
    step and its shardings in ``repro``'s order."""
    cfg = _cfg("qwen2-1.5b")
    rules = _rules((2, 2))
    shape = InputShape("t", 16, ROWS, "train")
    step, ps, opt_sh, bs = tsteps.jit_train_step(cfg, AdamW(), rules, shape)
    assert callable(step) and opt_sh == {"mu": ps, "nu": ps} and set(bs) == {"tokens", "labels"}
    assert _flatten(ps).keys() == _flatten(abstract_params(cfg)).keys()
    step, ps, cs, bs = tsteps.jit_serve_step(cfg, rules, InputShape("d", 16, ROWS, "decode"))
    assert callable(step) and set(bs) == {"tokens"} and "layer0" in cs
    step, ps, none, bs = tsteps.jit_prefill_step(cfg, rules, InputShape("p", 16, ROWS, "prefill"))
    assert callable(step) and none is None


# ----------------------------------------------- sharding names, optim

def test_rules_fingerprint_and_logical_shard_match_repro():
    """``rules_fingerprint`` is ``repro``'s signature of the active rules;
    ``logical_shard`` returns its input."""
    from repro.parallel import sharding as jsh
    from repro_torch.parallel import sharding as tsh

    class Fake:
        axis_names = ("data", "model")
        shape = {"data": 2, "model": 4}
    rules = {"batch": ("data",), "mlp": "model", "seq": None}
    with jsh.axis_rules(jsh.AxisRules(mesh=Fake(), rules=rules)):
        want = jsh.rules_fingerprint()
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), [CPU] * 8)
    assert tsh.rules_fingerprint() is None
    with axis_rules(AxisRules(mesh=mesh, rules=rules)):
        assert tsh.rules_fingerprint() == want
        x = torch.ones(2, 3)
        assert logical_shard(x, "batch", "mlp") is x


def test_schedules_match_repro():
    """``optim.schedule`` against ``repro.optim.schedule`` over steps 0-1200
    (warmup 100, total 1000), 1e-7, with ``tests/test_infra.py``'s values;
    ``repro_torch.optim`` exports ``repro.optim``'s names."""
    import repro.optim as jopt
    import repro_torch.optim as topt
    assert {"AdamW", "adamw_init", "adamw_update", "cosine_schedule",
            "linear_warmup"} <= set(dir(topt))
    for s in range(1201):
        for name in ("cosine_schedule", "linear_warmup"):
            args = (s, 100, 1000, 1.0) if name == "cosine_schedule" else (s, 100, 1.0)
            got = getattr(topt, name)(*args)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - float(getattr(jopt, name)(*args))) <= 1e-7, (name, s)
    assert float(topt.linear_warmup(torch.tensor(0), 100, 1.0)) < 0.02
    assert abs(float(topt.cosine_schedule(100, 100, 1000, 1.0)) - 1.0) < 0.01
    assert float(topt.cosine_schedule(1000, 100, 1000, 1.0)) < 0.2
