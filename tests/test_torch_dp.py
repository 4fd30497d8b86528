"""Port parity, single-mesh data parallelism: ``repro_torch``'s sharding rules
and data-parallel steps on the CPU against ``repro``'s, on reduced configs.

``repro`` runs in subprocesses with four forced host devices, started
together, as ``tests/test_torch_pipeline.py`` runs it: one computes the
``PartitionSpec``s of ``logical_spec``, ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` for every reduced config the
port builds, on a ``("data",)`` mesh of 4 and a ``("data", "model")`` mesh
of 2 x 2; one an arch trains 4 steps of ``jax.jit(make_train_step(...))``
under ``baseline_rules(make_host_mesh())`` at batch 8 (split over the 4
devices) and batch 6 (replicated). Under these rules ``repro`` routes
olmoe's MoE layers in 4 groups of the global batch's tokens, and its aux
loss takes the top-1 density of the whole batch; the port's steps route
each device's rows and form the aux loss to match. The port takes the same initial
parameters (``models.convert.params_from_numpy``) and the same numpy
batches, and trains under ``baseline_rules(make_host_mesh([cpu] * 4))``.

Tolerances, f32: specs equal entry by entry; losses and MoE aux losses
1e-4 x max(1, |loss|) and every parameter leaf 1e-4 x max(1, max |p|) at
each of the 4 steps; the port's data-parallel gradient against its
one-device gradient under the same rules (which pick the MoE group count,
as ``repro``'s step on one device would) 1e-4 x max(1, max |g|) (the shards
are summed in another order); generated tokens equal.

Mamba runs at sequence 64 in chunks of 32, where ``repro``'s
``ssd_chunked`` keeps finite gradients (see test_torch_ssm.py).
"""
import argparse
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adam import AdamW, leaves
from repro_torch.parallel.sharding import axis_rules, logical_spec

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")
ARCHS = ("qwen2-1.5b", "mamba2-130m", "olmoe-1b-7b")
SEQ = {"qwen2-1.5b": 32, "mamba2-130m": 64, "olmoe-1b-7b": 32}
BATCHES = (8, 6)                      # split over 4 devices; replicated
STEPS, LR, TOL = 4, 1e-3, 1e-4
# every reduced config
SPEC_ARCHS = ("qwen2-1.5b", "mamba2-130m", "yi-6b", "deepseek-7b", "minitron-4b",
              "olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b", "musicgen-large",
              "internvl2-26b")
MESHES = {"data4": ((4,), ("data",)), "data2x2": ((2, 2), ("data", "model"))}
# the SFB dense layer's MLP (parallel/sfb_dense.py::dp_mlp_loss): widths,
# rows (split over the 4 devices), gradient tolerance against repro's
MLP_WIDTHS, MLP_ROWS, MLP_TOL = (16, 32, 8), 8, 1e-5
SHAPES = [("train", 16, 8), ("train", 16, 6), ("decode", 16, 8), ("decode", 16, 6),
          ("decode", 12, 3)]
LOGICAL = [(("batch", "seq", "embed"), (8, 16, 64)), (("batch", "seq", "embed"), (6, 16, 64)),
           (("batch", None, "vocab"), (8, 1, 512)), (("vocab", "embed"), (512, 64)),
           (("embed", "mlp"), (64, 256)), (("batch", "cache_seq", "kv_heads", None),
                                            (6, 16, 2, 32)),
           (("layers", "embed", "q_heads"), (2, 64, 6)), (("batch", "batch"), (8, 8)),
           (("experts", "expert_embed", "mlp"), (4, 64, 256)), ((None, "seq"), (4, 4))]


def _cfg(arch):
    kw = {"ssm_chunk": 32} if arch == "mamba2-130m" else {}
    return get_reduced(arch).replace(dtype="float32", **kw)


def _batch(vocab: int, rows: int, seq: int, step: int) -> dict:
    rng = np.random.default_rng(100 * rows + step)
    return {k: rng.integers(0, vocab, (rows, seq)).astype(np.int32) for k in ("tokens", "labels")}


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


def _mlp_inputs():
    """The MLP's weights, inputs and targets (numpy, f32)."""
    rng = np.random.default_rng(0)
    params = [(rng.standard_normal((a, b)) * 0.1).astype(np.float32)
              for a, b in zip(MLP_WIDTHS[:-1], MLP_WIDTHS[1:])]
    x = rng.standard_normal((MLP_ROWS, MLP_WIDTHS[0])).astype(np.float32)
    y = rng.standard_normal((MLP_ROWS, MLP_WIDTHS[-1])).astype(np.float32)
    return params, x, y


def _canon(spec) -> list:
    """A spec's entries as JSON: a tuple of mesh axes becomes a list."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


_JAX_SCRIPT = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.shapes import InputShape
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import init_params
from repro.optim.adam import AdamW
from repro.parallel.sharding import axis_rules, logical_spec
from repro.configs import get_reduced
sys.path.insert(0, {test_dir!r})
from test_torch_dp import (
    BATCHES, LOGICAL, LR, MESHES, MLP_WIDTHS, SEQ, SHAPES, SPEC_ARCHS, STEPS, _batch, _canon,
    _flatten, _mlp_inputs)

assert len(jax.devices()) == 4, jax.devices()
out, what = sys.argv[1], sys.argv[2]
if what == "specs":
    res = {{}}
    for mname, (shape, axes) in MESHES.items():
        rules = jsteps.baseline_rules(jmesh.make_mesh(shape, axes))
        with axis_rules(rules):
            res[f"{{mname}}/logical"] = [_canon(logical_spec(ax, shape=s)) for ax, s in LOGICAL]
        for arch in SPEC_ARCHS:
            cfg = get_reduced(arch)
            tree = jax.tree.map(lambda s: _canon(s.spec), jsteps.param_shardings(cfg, rules),
                                is_leaf=lambda x: isinstance(x, NamedSharding))
            res[f"{{mname}}/{{arch}}/params"] = _flatten(tree)
            for kind, seq, b in SHAPES:
                shp = InputShape("s", seq, b, kind)
                res[f"{{mname}}/{{arch}}/batch/{{kind}}/{{seq}}/{{b}}"] = {{
                    k: _canon(v.spec) for k, v in jsteps.batch_shardings(cfg, shp, rules).items()}}
                if kind == "decode":
                    cs = jax.tree.map(lambda s: _canon(s.spec),
                                      jsteps.cache_shardings(cfg, shp, rules),
                                      is_leaf=lambda x: isinstance(x, NamedSharding))
                    res[f"{{mname}}/{{arch}}/cache/{{seq}}/{{b}}"] = _flatten(cs)
    with open(out, "w") as f:
        json.dump(res, f)
elif what == "mlp":
    from repro.parallel.sfb_dense import dp_mlp_loss
    params, x, y = _mlp_inputs()
    mesh = jmesh.make_mesh((4,), ("data",))
    res = {{}}
    for sync in ("allreduce", "ps", "sfb"):
        g = jax.jit(jax.grad(dp_mlp_loss(mesh, "data", sync, MLP_WIDTHS)))(
            [jnp.asarray(p) for p in params], jnp.asarray(x), jnp.asarray(y))
        for i, gi in enumerate(g):
            res[f"{{sync}}/{{i}}"] = np.asarray(gi)
    np.savez(out, **res)
else:
    arch = what
    kw = {{"ssm_chunk": 32}} if arch == "mamba2-130m" else {{}}
    cfg = get_reduced(arch).replace(dtype="float32", **kw)
    init = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    res = {{f"init/{{k}}": v for k, v in _flatten(init).items()}}
    opt = AdamW(lr=LR)
    rules = jsteps.baseline_rules(jmesh.make_host_mesh())
    step_fn = jax.jit(jsteps.make_train_step(cfg, opt, rules))
    for rows in BATCHES:
        params = jax.tree.map(jnp.asarray, init)
        state = opt.init(params)
        for step in range(STEPS):
            params, state, m = step_fn(params, state, jnp.asarray(step, jnp.int32),
                                       jax.tree.map(jnp.asarray, _batch(cfg.vocab_size, rows,
                                                                        SEQ[arch], step)))
            res[f"{{rows}}/{{step}}/loss"] = np.float64(m["loss"])
            res[f"{{rows}}/{{step}}/aux"] = np.float64(m["aux"])
            for k, v in _flatten(jax.tree.map(np.asarray, params)).items():
                res[f"{{rows}}/{{step}}/params/{{k}}"] = v
    np.savez(out, **res)
print("JAX_DP_OK")
"""


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """``repro``'s specs, 4-step trajectories and SFB-MLP gradients: one
    subprocess for the specs, one for the MLP and one an arch, all started
    together."""
    tmp = tmp_path_factory.mktemp("jaxdp")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_SCRIPT.format(
        test_dir=os.path.dirname(os.path.abspath(__file__))))
    jobs = {"specs": str(tmp / "specs.json"), "mlp": str(tmp / "mlp.npz"),
            **{a: str(tmp / f"{a}.npz") for a in ARCHS}}
    procs = {what: subprocess.Popen([sys.executable, "-c", code, out, what], env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for what, out in jobs.items()}
    res = {}
    for what, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "JAX_DP_OK" in stdout, stderr[-3000:]
        if what == "specs":
            with open(jobs[what]) as f:
                res["specs"] = json.load(f)
        else:
            with np.load(jobs[what]) as f:
                res[what] = {k: f[k] for k in f.files}
    return res


def _port_mesh(name):
    shape, axes = MESHES[name]
    return tmesh.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_spec_matches_repro(jax_dp, mesh):
    rules = tsteps.baseline_rules(_port_mesh(mesh))
    with axis_rules(rules):
        got = [_canon(logical_spec(ax, shape=s)) for ax, s in LOGICAL]
    assert got == jax_dp["specs"][f"{mesh}/logical"]
    assert logical_spec(("batch", "seq")) == ()             # no rules: replicated


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_shardings_match_repro(jax_dp, arch, mesh):
    """``param_shardings``, ``batch_shardings`` and ``cache_shardings``
    equal ``repro``'s entry by entry."""
    rules = tsteps.baseline_rules(_port_mesh(mesh))
    cfg = get_reduced(arch)
    specs = jax_dp["specs"]
    got = {k: _canon(v.spec) for k, v in _flatten(tsteps.param_shardings(cfg, rules)).items()}
    assert got == specs[f"{mesh}/{arch}/params"]
    for kind, seq, b in SHAPES:
        shp = InputShape("s", seq, b, kind)
        got = {k: _canon(v.spec) for k, v in tsteps.batch_shardings(cfg, shp, rules).items()}
        assert got == specs[f"{mesh}/{arch}/batch/{kind}/{seq}/{b}"], (kind, seq, b)
        if kind == "decode":
            got = {k: _canon(v.spec)
                   for k, v in _flatten(tsteps.cache_shardings(cfg, shp, rules)).items()}
            assert got == specs[f"{mesh}/{arch}/cache/{seq}/{b}"], (seq, b)


def test_abstract_params_and_specs_live_on_meta():
    from repro_torch.models import model as tmodel
    cfg = get_reduced("qwen2-1.5b")
    ap = tmodel.abstract_params(cfg)
    real = tmodel.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    assert {k: (v.shape, v.dtype) for k, v in _flatten(ap).items()} == {
        k: (v.shape, v.dtype) for k, v in _flatten(real).items()}
    assert all(v.is_meta for v in leaves(ap))
    assert _flatten(tmodel.param_axes(cfg)).keys() == _flatten(real).keys()
    cs = tmodel.cache_specs(cfg, 3, 10)
    assert all(v.is_meta for v in leaves(cs))
    assert {k: v.shape for k, v in _flatten(cs).items()} == {
        k: v.shape for k, v in _flatten(tmodel.init_cache(cfg, 3, 10, CPU)).items()}
    assert {k: v.shape for k, v in tmodel.input_specs(
        cfg, InputShape("t", 16, 4, "train")).items()} == {"tokens": (4, 16), "labels": (4, 16)}


# ---------------------------------------------------------- train step

@pytest.mark.parametrize("rows", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_train_step_matches_repro(jax_dp, arch, rows):
    """Four steps of ``make_train_step`` over ``[cpu] * 4`` against
    ``repro``'s jitted step over 4 host devices: each step's loss and the
    parameters after it."""
    ref = jax_dp[arch]
    cfg = _cfg(arch)
    init = {k[len("init/"):]: v for k, v in ref.items() if k.startswith("init/")}
    params = params_from_numpy(_unflatten(init), CPU)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    rules = tsteps.baseline_rules(tmesh.make_host_mesh([CPU] * 4))
    step_fn = tsteps.make_train_step(cfg, opt, rules)
    for step in range(STEPS):
        batch = {k: torch.as_tensor(v).long()
                 for k, v in _batch(cfg.vocab_size, rows, SEQ[arch], step).items()}
        params, state, m = step_fn(params, state, step, batch)
        want = float(ref[f"{rows}/{step}/loss"])
        assert abs(float(m["loss"]) - want) <= TOL * max(1.0, abs(want)), step
        want = float(ref[f"{rows}/{step}/aux"])
        assert abs(float(m["aux"]) - want) <= TOL * max(1.0, abs(want)), step
        assert (want > 0) == (arch == "olmoe-1b-7b")
        for k, v in _flatten(params).items():
            w = ref[f"{rows}/{step}/params/{k}"]
            np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                       atol=TOL * max(1.0, float(np.abs(w).max())),
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("rows", BATCHES)
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_grads_match_one_device(arch, n_dev, rows):
    """The data-parallel loss, metrics and gradient over ``[cpu] * n``
    against the one-device step's under the same rules, from the same
    parameters and batch."""
    from repro_torch.models.model import init_params
    cfg = _cfg(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = {k: torch.as_tensor(v).long()
             for k, v in _batch(cfg.vocab_size, rows, SEQ[arch], 0).items()}
    rules = tsteps.baseline_rules(tmesh.make_host_mesh([CPU] * n_dev))
    with axis_rules(rules):
        l1, m1, g1 = tsteps.make_grad_step(cfg, None)(params, batch)
    ln, mn, gn = tsteps.make_grad_step(cfg, rules)(params, batch)
    assert abs(float(ln) - float(l1)) <= TOL * abs(float(l1))
    for k in ("ce", "aux"):
        assert abs(float(mn[k]) - float(m1[k])) <= TOL * max(1.0, abs(float(m1[k]))), k
    for a, b in zip(leaves(gn), leaves(g1), strict=True):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())


def test_tensor_parallel_rules_raise():
    """Rules that shard a parameter dim (a ``"model"`` axis of size 2) are
    tensor parallelism, which waits for ROADMAP queue 1, item 10; a
    ``"model"`` axis of size 1 is data parallelism."""
    cfg = _cfg("qwen2-1.5b")
    tp = tsteps.baseline_rules(tmesh.make_mesh((2, 2), ("data", "model"), [CPU] * 4))
    for build in (lambda r: tsteps.make_train_step(cfg, AdamW(), r),
                  lambda r: tsteps.make_prefill_step(cfg, r),
                  lambda r: tsteps.make_serve_step(cfg, r)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
            build(tp)
    dp = tsteps.baseline_rules(tmesh.make_mesh((2, 1), ("data", "model"), [CPU] * 2))
    assert tsteps.data_devices(cfg, dp) == [CPU, CPU]
    with pytest.raises(TypeError, match="AxisRules"):
        tsteps.make_train_step(cfg, AdamW(), tsteps.StepOptions())


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("rows", [4, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_generate_and_prefill_match_one_device(arch, rows):
    """``generate`` and the prefill step over ``[cpu] * 2``: the rows split
    (4) or replicated (3) over the devices, the tokens and logits those of
    one device under the same rules."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import init_params
    cfg = _cfg(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    prompts = np.random.default_rng(rows).integers(0, cfg.vocab_size, (rows, 6))
    rules = tsteps.baseline_rules(tmesh.make_host_mesh([CPU] * 2))
    stats: dict = {}
    batch = {"tokens": torch.as_tensor(prompts)}
    with axis_rules(rules):
        one = generate(cfg, params, prompts, 5)
        b = tsteps.make_prefill_step(cfg, None)(params, batch)
    dp = generate(cfg, params, prompts, 5, rules, stats=stats)
    assert dp.shape == (rows, 5) and torch.equal(dp, one)
    assert stats["decode_steps"] == 5
    a = tsteps.make_prefill_step(cfg, rules)(params, batch)
    assert a.shape == b.shape == (rows, 1, cfg.vocab_size)
    assert (a - b).abs().max().item() <= 1e-5


# ------------------------------------------------------- no CPU fallback

def test_no_device_list_needs_a_card(tmp_path):
    """Without a card, ``local_devices``, the host mesh, ``stage_device_sets``
    and ``run_pipeline`` given no device list raise; they ran on the CPU
    before."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.exec import StagePlan, StageSpec
    from repro_torch.launch.train import run_pipeline

    def plan(n_stages):
        return StagePlan(stages=[StageSpec(i, i, [i], 1e9, 0, 0, 1e5) for i in range(n_stages)],
                         placement=tuple(range(n_stages)), n_micro=2)

    for call in (tmesh.local_devices, tmesh.make_host_mesh,
                 lambda: tmesh.stage_device_sets(plan(1)),
                 lambda: tmesh.stage_device_sets(plan(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    args = argparse.Namespace(
        arch="qwen2-1.5b", batch=4, seq=16, lr=1e-3, seed=0, steps=1, log_every=1,
        ckpt_dir=str(tmp_path), ckpt_every=1, resume=False, pipeline="1f1b", n_micro=2,
        n_chunks=2, telemetry_dir="", engine="eager")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(args, _cfg("qwen2-1.5b"), plan(1))
    assert not os.listdir(tmp_path)
    assert tmesh.make_host_mesh([CPU] * 3).shape == {"data": 3}


@pytest.mark.parametrize("sync", ["allreduce", "ps", "sfb"])
def test_dp_mlp_loss_grads_match_repro(jax_dp, sync):
    """``dp_mlp_loss`` over ``[cpu] * 4`` on the ``"data"`` axis: the
    gradients of ``repro``'s jitted ``dp_mlp_loss`` on 4 host devices, and
    of the same MLP on one device, 1e-5; ``w`` gets the sync's sum once (a
    second sum through the shards' copies of ``w`` would double it)."""
    from repro_torch.parallel.sfb_dense import dp_mlp_loss
    params, x, y = _mlp_inputs()
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    mesh = tmesh.make_mesh((4,), ("data",), [CPU] * 4)
    loss = dp_mlp_loss(mesh, "data", sync, MLP_WIDTHS)(ps, torch.tensor(x), torch.tensor(y))
    got = torch.autograd.grad(loss, ps)
    h = torch.tensor(x)
    for i, w in enumerate(ps):
        h = h @ w if i == len(ps) - 1 else torch.relu(h @ w)
    one = torch.autograd.grad(((h - torch.tensor(y)) ** 2).mean(), ps)
    for i, (g, ref) in enumerate(zip(got, one)):
        np.testing.assert_allclose(g.numpy(), jax_dp["mlp"][f"{sync}/{i}"], rtol=0, atol=MLP_TOL)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=0, atol=MLP_TOL)
