"""Port parity, parameters split over the batch axes (FSDP, or ZeRO-3):
``repro_torch``'s steps under ``baseline_rules`` with ``embed=data`` or
``expert_embed=data`` against ``repro``'s under the same rules, on reduced
configs in f32.

``repro`` runs in one subprocess a case, all started together, with four
forced host devices: under the case's rules it takes the loss and
``jax.grad`` of ``loss_fn`` (inside ``axis_rules``), the jitted prefill
step's logits and ``generate``'s tokens, and passes them back as an
``.npz``. The port takes the same parameters
(``models.convert.params_from_numpy``) and numpy batches, lays them out
with ``parallel.tensor.shard_params`` over ``[cpu] * 4``, and runs
``make_grad_step``, ``make_prefill_step`` and ``serve.generate``. The
cases (``CASES``): qwen2-1.5b and mamba2-130m with ``embed=data`` and
olmoe-1b-7b with ``expert_embed=data`` over a (2, 2) ``("data", "model")``
mesh, where a leaf is split over the rows and over ``"model"`` at once;
qwen2-1.5b with ``embed=data`` over (4, 1), ZeRO-3 without tensor
parallelism; and over (2, 2, 1) ``("pod", "data", "model")``, where the
rows of one pod share their slices and the two pods hold copies.

Tolerances, f32, as ``tests/test_torch_tp.py``'s: losses 1e-4 x |loss|;
each gradient leaf 1e-4 x max |b|; prefill logits 1e-4; generated tokens
equal; four ``make_train_step`` steps track one device within 1e-4 on the
loss and grad_norm and ``PARAM_TOL`` x max(1, max |p|) on each gathered
parameter. Each position's shard shape equals ``repro``'s
``param_shardings`` shard shape for every full-size config at (2, 2) and
(4, 2), and the shards gather back bit for bit.

Mamba runs at sequence 64 in chunks of 32, where ``repro``'s
``ssd_chunked`` keeps finite gradients (see test_torch_ssm.py).
"""
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
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import abstract_params, init_params
from repro_torch.optim.adam import AdamW, leaves
from repro_torch.parallel import tensor as tp
from repro_torch.parallel.sharding import axis_rules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
DM = ("data", "model")
# case -> (arch, rule overrides, mesh shape, mesh axes)
CASES = {
    "qwen2-1.5b": ("qwen2-1.5b", {"embed": "data"}, (2, 2), DM),
    "mamba2-130m": ("mamba2-130m", {"embed": "data"}, (2, 2), DM),
    "olmoe-1b-7b": ("olmoe-1b-7b", {"expert_embed": "data"}, (2, 2), DM),
    "qwen2-1.5b-4x1": ("qwen2-1.5b", {"embed": "data"}, (4, 1), DM),
    "qwen2-1.5b-pod": ("qwen2-1.5b", {"embed": "data"}, (2, 2, 1), ("pod", "data", "model")),
}
SEQ = {"qwen2-1.5b": 32, "mamba2-130m": 64, "olmoe-1b-7b": 32}
ROWS, PROMPT, GEN, TOL = 4, 16, 6, 1e-4
STEPS, LR = 4, 1e-3
PARAM_TOL = {1e-3: 1e-4}


def _cfg(case):
    arch = CASES[case][0]
    kw = {"ssm_chunk": 32} if arch == "mamba2-130m" else {}
    return get_reduced(arch).replace(dtype="float32", **kw)


def _batch(vocab: int, rows: int, seq: int, step: int) -> dict:
    rng = np.random.default_rng(2000 + 10 * rows + step)
    return {k: rng.integers(0, vocab, (rows, seq)).astype(np.int32) for k in ("tokens", "labels")}


def _prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(11).integers(0, vocab, (ROWS, PROMPT)).astype(np.int32)


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
from test_torch_fsdp import CASES, GEN, ROWS, SEQ, _batch, _flatten, _prompts

assert len(jax.devices()) == 4, jax.devices()
out, case = sys.argv[1], sys.argv[2]
arch, overrides, shape, axes = CASES[case]
kw = {{"ssm_chunk": 32}} if arch == "mamba2-130m" else {{}}
cfg = get_reduced(arch).replace(dtype="float32", **kw)
params = init_params(cfg, jax.random.PRNGKey(0))
res = {{f"init/{{k}}": np.asarray(v) for k, v in _flatten(params).items()}}
rules = jsteps.baseline_rules(jmesh.make_mesh(shape, axes), overrides=overrides)

def loss(p, b):
    with axis_rules(rules):
        return loss_fn(cfg, p, b, remat=False)[0]

batch = jax.tree.map(jnp.asarray, _batch(cfg.vocab_size, ROWS, SEQ[arch], 0))
l, g = jax.jit(jax.value_and_grad(loss))(params, batch)
res["loss"] = np.float64(l)
for k, v in _flatten(g).items():
    res[f"grad/{{k}}"] = np.asarray(v)
prompts = jnp.asarray(_prompts(cfg.vocab_size))
res["prefill"] = np.asarray(jax.jit(jsteps.make_prefill_step(cfg, rules))(
    params, {{"tokens": prompts}}))
res["tokens"] = np.asarray(generate(cfg, params, prompts, GEN, rules))
np.savez(out, **res)
print("JAX_FSDP_OK")
"""


@pytest.fixture(scope="module")
def jax_fsdp(tmp_path_factory):
    """``repro``'s loss, gradients, prefill logits and tokens under each
    case's rules: one subprocess a case, all started together."""
    tmp = tmp_path_factory.mktemp("jaxfsdp")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_SCRIPT.format(
        test_dir=os.path.dirname(os.path.abspath(__file__))))
    outs = {c: str(tmp / f"{c}.npz") for c in CASES}
    procs = {c: subprocess.Popen([sys.executable, "-c", code, out, c], env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for c, out in outs.items()}
    res = {}
    for c, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "JAX_FSDP_OK" in stdout, stderr[-3000:]
        with np.load(outs[c]) as f:
            res[c] = {k: f[k] for k in f.files}
    return res


def _rules(case, devices=None):
    _, overrides, shape, axes = CASES[case]
    n = int(np.prod(shape))
    mesh = tmesh.make_mesh(shape, axes, devices or [CPU] * n)
    return tsteps.baseline_rules(mesh, overrides=overrides)


def _params(ref):
    return params_from_numpy(_unflatten({k[5:]: v for k, v in ref.items()
                                         if k.startswith("init/")}), CPU)


def _torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def _close_grads(got, want, what):
    flat = _flatten(got)
    for k, w in _flatten(want).items():
        w = w if isinstance(w, np.ndarray) else w.detach().numpy()
        np.testing.assert_allclose(flat[k].detach().numpy(), w, rtol=0,
                                   atol=TOL * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"{what} {k}")


def _split_leaves(lay) -> list:
    return [r for r in leaves(lay.row_dims) if r is not None]


# ------------------------------------------------------------- gradients

@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_grads_match_repro(jax_fsdp, case):
    """Loss and every gradient leaf of ``make_grad_step`` under the case's
    rules against ``jax.grad`` of ``repro``'s ``loss_fn`` under the same
    rules. Position 0 all-gathers each leaf split over the rows before each
    period, again in the checkpointed recompute, and reduce-scatters the
    gradient of each such leaf once, its whole bytes: qwen2's 9 leaves a
    layer (both norms, the attention and MLP projections), and the
    embedding (the lookup and the tied head) and final norm."""
    ref, cfg = jax_fsdp[case], _cfg(case)
    arch = CASES[case][0]
    rules = _rules(case)
    lay = tp.layout(cfg, rules)
    split = _split_leaves(lay)
    assert split and lay.sharded and "split over the rows" in tp.describe(lay)
    shards = tp.shard_params(cfg, _params(ref), rules)
    with tp.collectives() as coll:
        loss, _, grads = tsteps.make_grad_step(cfg, rules)(
            shards, _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[arch], 0)))
    want = float(ref["loss"])
    assert abs(float(loss) - want) <= TOL * abs(want)
    _close_grads(tp.gather_params(cfg, grads, rules),
                 {k[5:]: v for k, v in ref.items() if k.startswith("grad/")}, case)
    mine = coll.of(0)
    whole = sum(t.numel() * 4 * r.n for t, r in zip(leaves(shards[0]), leaves(lay.row_dims),
                                                   strict=True) if r is not None)
    assert mine["reduce-scatter"] == (len(split), whole)
    if arch == "qwen2-1.5b":
        # the logits' column gather where the head splits over "model"
        assert mine["all-gather"][0] == 2 * 9 * cfg.num_layers + 3 + (lay.m > 1)


@pytest.mark.parametrize("options", [
    {"loss_chunk": 8}, {"remat_policy": "dots"}, {"remat_policy": "none"},
    {"remat": False, "loss_chunk": 16}], ids=["chunk8", "dots", "none", "noremat-chunk16"])
def test_fsdp_step_options_match_one_device(options):
    """``StepOptions`` with leaves split over the rows: the CE in
    checkpointed chunks, each gathering the tied head, and each remat policy
    over the period whose leaves it gathers, against one device with the
    same options."""
    case = "qwen2-1.5b"
    cfg = _cfg(case)
    rules = _rules(case)
    opts = tsteps.StepOptions(**options)
    params = init_params(cfg, torch.Generator().manual_seed(2), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, ROWS, SEQ[case], 2))
    with axis_rules(rules):
        l1, _, g1 = tsteps.make_grad_step(cfg, None, opts)(params, batch)
    for t in leaves(params):
        t.requires_grad_(False)
    ln, _, gn = tsteps.make_grad_step(cfg, rules, opts)(tp.shard_params(cfg, params, rules),
                                                        batch)
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    _close_grads(tp.gather_params(cfg, gn, rules), g1, str(options))


# --------------------------------------------------------------- serving

@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_prefill_and_generate_match_repro(jax_fsdp, case):
    """The prefill step's logits and ``generate``'s tokens under the case's
    rules against ``repro``'s: each period's leaves gathered over the rows
    before it runs, in the prefill and in every decode step."""
    from repro_torch.launch.serve import generate
    ref, cfg = jax_fsdp[case], _cfg(case)
    rules = _rules(case)
    params = _params(ref)
    prompts = _prompts(cfg.vocab_size)
    logits = tsteps.make_prefill_step(cfg, rules)(
        tp.shard_params(cfg, params, rules), {"tokens": torch.as_tensor(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], rtol=0, atol=TOL)
    toks = generate(cfg, params, prompts, GEN, rules)
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"])


# ----------------------------------------------------------- train step

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_train_step_tracks_one_device(case):
    """Four ``make_train_step`` steps under the case's rules, clipping by
    the norm over each distinct slice once and AdamW on each position's
    slice (moments laid out by ``shard_state``), against one device's: each
    step's loss and grad_norm, and every parameter gathered from its
    shards."""
    cfg = _cfg(case)
    arch = CASES[case][0]
    rules = _rules(case)
    p0 = init_params(cfg, torch.Generator().manual_seed(1), CPU)
    opt = AdamW(lr=LR)
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
                                       atol=PARAM_TOL[LR] * max(1.0, w.abs().max().item()),
                                       err_msg=f"step {step} {k}")


# ---------------------------------------------------------------- layout

def _repro_shard_shapes(jcfg, shape, overrides) -> dict:
    """``repro``'s local shard shape of every leaf under ``baseline_rules``
    with ``overrides`` on a ``("data", "model")`` mesh of ``shape``:
    ``NamedSharding.shard_shape`` of ``param_shardings``, each dim over the
    product of its spec entry's mesh axes."""
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    from repro.parallel import sharding as jsh

    class Fake:
        axis_names = DM
    mesh = Fake()
    mesh.shape = dict(zip(DM, shape))
    rules = jsteps.baseline_rules(mesh, overrides=overrides)
    out = {}
    abstract = _flatten(jmodel.abstract_params(jcfg))
    for k, ax in _flatten(jmodel.param_axes(jcfg)).items():
        dims = list(abstract[k].shape)
        with jsh.axis_rules(rules):
            spec = tuple(jsh.logical_spec(ax, shape=tuple(dims)))
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,)) if e is not None else ():
                dims[d] //= mesh.shape[a]
        out[k] = tuple(dims)
    return out


@pytest.mark.parametrize("override", ["embed", "expert_embed"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_shard_shapes_match_repro(arch, shape, override):
    """Every full-size config with ``override`` on ``"data"``: each
    position's shard of every leaf (``shard_params`` on ``meta``) has
    ``repro``'s local shard shape, so that a position holds ``repro``'s
    parameter bytes, and row ``i`` of a leaf split over ``"data"`` holds
    slice ``i``."""
    import repro.configs as jconfigs
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    n = shape[0] * shape[1]
    mesh = tmesh.make_mesh(shape, DM, [torch.device("meta")] * n)
    rules = tsteps.baseline_rules(mesh, overrides={override: "data"})
    lay = tp.layout(cfg, rules)
    want = _repro_shard_shapes(jcfg, shape, {override: "data"})
    shards = tp.shard_params(cfg, abstract_params(cfg), rules)
    for p in range(n):
        got = {k: tuple(t.shape) for k, t in _flatten(shards[p]).items()}
        assert got == want, p
    for r in _split_leaves(lay):
        assert r.axes == ("data",) and r.n == shape[0]
        assert [lay.row_slice(i, r) for i in range(lay.n)] == list(range(shape[0]))
    if override == "embed":
        assert _split_leaves(lay)
    else:
        assert bool(_split_leaves(lay)) == (cfg.num_experts > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_shard_and_gather_round_trip(case):
    """``shard_params`` cuts each leaf split over the rows into equal,
    contiguous slices of its column's slice, views of the leaf (of a copy
    for a split Mamba-2 mixer's packed leaves), one tensor for every
    position that holds the same slice on one device; ``holders`` names the
    positions of a position's column in its row group, in shard order (over
    (2, 2, 1) the rows of its pod); ``gather_params`` returns the tree bit
    for bit."""
    cfg = _cfg(case)
    rules = _rules(case)
    lay = tp.layout(cfg, rules)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    shards = tp.shard_params(cfg, params, rules)
    assert len(shards) == 4
    flat = [leaves(t) for t in shards]
    for k, (whole, d, r, seg) in enumerate(zip(leaves(params), leaves(lay.dims),
                                               leaves(lay.row_dims), leaves(lay.segments),
                                               strict=True)):
        if r is None:
            continue
        for p in range(4):
            i, j = divmod(p, lay.m)
            t = flat[p][k]
            w = whole.shape[r.dim] // r.n
            s = lay.row_slice(i, r)
            if d is None:
                col = whole
            else:
                # a split Mamba-2 mixer's packed leaves: the j-th 1/m of
                # each segment (tests/test_torch_tp.py), else a range
                cuts, off = [], 0
                for n in seg or (whole.shape[d],):
                    cuts.append(whole.narrow(d, off + j * (n // lay.m), n // lay.m))
                    off += n
                col = torch.cat(cuts, d)
            assert torch.equal(t, col.narrow(r.dim, s * w, w)), (k, p)
            if seg is None:
                assert t.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
            holders = lay.holders(p, r)
            assert [lay.row_slice(q // lay.m, r) for q in holders] == list(range(r.n))
            assert all(q % lay.m == j for q in holders)
            for q in range(4):
                same = lay.row_slice(q // lay.m, r) == s and (d is None or q % lay.m == j)
                assert (flat[q][k] is t) == same, (k, p, q)
    if CASES[case][3][0] == "pod":
        r = next(r for r in leaves(lay.row_dims) if r is not None)
        assert [lay.holders(p, r) for p in range(4)] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    back = tp.gather_params(cfg, shards, rules)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(params), strict=True))
