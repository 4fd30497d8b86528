"""Port parity, training: ``repro_torch``'s loss, gradients, AdamW, train
step, data, checkpoints, telemetry and train launcher on the CPU against
``repro``'s, on reduced qwen2-1.5b and mamba2-130m (2 layers), from the same
weights (drawn by ``repro.models.init_params``, carried over by
``repro_torch.models.convert``) and the same ``SyntheticDataset`` batches.

Tolerances, f32 unless stated:
- loss 1e-5 relative; every gradient leaf 1e-4 x max(1, max |g|) (the two
  frameworks sum in another order);
- AdamW: bit for bit with f32 moments; with bf16 moments within one bf16
  step of the moments; the clipping norm 1e-6 relative (a sum over every
  leaf, in another order);
- a 4-step loss trajectory 1e-4 relative per step;
- ``SyntheticDataset`` batches and checkpoint leaves: equal, bit for bit;
- resuming a bf16 run: losses within 5e-2 of ``repro``'s own resume, the
  bf16 tolerance of the port's other parity tests (bf16 rounds at other
  places in the two frameworks, and its relative step is 2^-8).

Mamba runs at sequence 64 in chunks of 32: at the model's initial step sizes
``repro``'s ``ssd_chunked`` keeps finite gradients only while a chunk's
decay stays under about 88 (see test_torch_ssm.py).
"""
import functools
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import models as jmodels
from repro.checkpoint import ckpt as jckpt
from repro.configs import get_reduced as jax_get_reduced
from repro.data.synthetic import SyntheticDataset as JaxDataset
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.optim import adam as jadam
from repro.runtime.telemetry import MeasurementStore as JaxMeasurementStore
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adam as tadam

ARCHS = ("qwen2-1.5b", "mamba2-130m")
CPU = torch.device("cpu")
BATCH, SEQ = 2, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TRAJ_RTOL = 1e-4
RESUME_BF16_ATOL = 5e-2


def _cfgs(arch, dtype="float32"):
    kw = {"ssm_chunk": 32} if arch == "mamba2-130m" else {}
    return (jax_get_reduced(arch).replace(dtype=dtype, **kw),
            get_reduced(arch).replace(dtype=dtype, **kw))


@functools.cache
def _setup(arch):
    """Reduced f32 configs, the JAX parameters as numpy, and one batch."""
    jcfg, tcfg = _cfgs(arch)
    init = jax.jit(jmodels.init_params, static_argnums=0)
    jp = jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))
    batch = JaxDataset(jcfg.vocab_size, SEQ, BATCH, seed=3).batch(0)
    return jcfg, tcfg, jp, batch


@functools.cache
def _jax_loss_and_grads(arch, loss_chunk):
    """``repro``'s loss and gradients, under its default remat policy: a
    JAX remat policy changes what the backward pass recomputes, not a value."""
    jcfg, _, jp, batch = _setup(arch)
    f = jax.jit(jax.value_and_grad(lambda p, b: jmodels.loss_fn(
        jcfg, p, b, loss_chunk=loss_chunk)[0]))
    loss, grads = f(jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    return float(loss), jax.tree.map(np.asarray, grads)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("policy", sorted(ttf.REMAT_POLICIES))
@pytest.mark.parametrize("loss_chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, loss_chunk, policy):
    """``loss_fn`` under each of the port's remat policies, and the gradient
    of every leaf, against ``jax.value_and_grad`` of ``repro.models.loss_fn``
    with the same ``loss_chunk`` (0: one head product; 16: four chunks)."""
    _, tcfg, jp, batch = _setup(arch)
    ref_loss, ref_grads = _jax_loss_and_grads(arch, loss_chunk)
    tp = params_from_numpy(jp, CPU)
    leaves = tadam.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(tcfg, tp, _torch_batch(batch), loss_chunk=loss_chunk,
                                   remat_policy=policy)
    assert float(metrics["aux"]) == 0.0 and float(metrics["ce"].detach()) == float(loss.detach())
    np.testing.assert_allclose(float(loss.detach()), ref_loss, rtol=LOSS_RTOL)
    grads = dict(zip(_flat(tp), (_np(g) for g in torch.autograd.grad(loss, leaves))))
    ref = _flat(ref_grads)
    assert grads.keys() == ref.keys()
    for name, g in grads.items():
        tol = GRAD_TOL * max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g, ref[name], rtol=0, atol=tol, err_msg=name)


def test_unknown_remat_policy_raises():
    _, tcfg, jp, batch = _setup("qwen2-1.5b")
    with pytest.raises(ValueError, match="remat_policy"):
        tmodel.loss_fn(tcfg, params_from_numpy(jp, CPU), _torch_batch(batch),
                       remat_policy="offload")


# ------------------------------------------------------------------ AdamW

def _opt_tree(rng, dtype=np.float32):
    """A 3-D stacked matrix, a 2-D matrix and a 1-D vector (no weight decay)."""
    return {"blocks": {"w": rng.standard_normal((2, 6, 5)).astype(dtype)},
            "head": rng.standard_normal((5, 7)).astype(dtype),
            "norm": rng.standard_normal((7,)).astype(dtype)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    """Three steps from the same parameters and gradients."""
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    jopt = jadam.AdamW(lr=1e-2, state_dtype=state_dtype)
    topt = tadam.AdamW(lr=1e-2, state_dtype=state_dtype)
    jp, js = jax.tree.map(jnp.asarray, p0), jopt.init(jax.tree.map(jnp.asarray, p0))
    tp = params_from_numpy(p0, CPU)
    ts = topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jp, js, jax.tree.map(jnp.asarray, g), step)
        tp, ts = topt.update(tp, ts, params_from_numpy(g, CPU), step)
    for name, a in _flat(jax.tree.map(np.asarray, jp)).items():
        b = _flat(params_to_numpy(tp))[name]
        if state_dtype == "float32":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:       # the moments may round to a neighbouring bf16 value
            np.testing.assert_allclose(b, a, rtol=2 ** -7, err_msg=name)
    for which in ("mu", "nu"):
        ref = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), js[which]))
        got = _flat(ts[which])
        for name, a in ref.items():
            b = _np(got[name])
            assert got[name].dtype == getattr(torch, state_dtype)
            if state_dtype == "float32":
                np.testing.assert_array_equal(b, a, err_msg=f"{which}.{name}")
            else:   # one bf16 step: 2^-7 relative at most
                np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=0, err_msg=f"{which}.{name}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipped (0.5) and left alone (100); bf16 leaves keep their dtype."""
    rng = np.random.default_rng(1)
    g = _opt_tree(rng)
    g["norm"] = g["norm"].astype(jnp.bfloat16)
    jg, jn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
    tg, tn = tadam.clip_by_global_norm(params_from_numpy(g, CPU), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert tg["norm"].dtype == torch.bfloat16
    ref = _flat(jax.tree.map(lambda x: np.asarray(x, np.float32), jg))
    for name, t in _flat(tg).items():
        np.testing.assert_allclose(_np(t), ref[name], rtol=1e-6 if t.dtype == torch.float32
                                   else 2 ** -8, err_msg=name)


# ------------------------------------------------------------- train step

def test_train_step_trajectory_matches_jax():
    """Four steps of the port's ``make_train_step`` against
    ``repro.launch.steps.make_train_step``, jitted on the host mesh with
    ``baseline_rules``, from the same parameters and batches, on qwen2-smoke.
    The step is the same code for both archs; mamba2-smoke's gradients are
    held to ``repro``'s in ``test_loss_and_grads_match_jax``."""
    jcfg, tcfg, jp, _ = _setup("qwen2-1.5b")
    opt_kw = {"lr": 1e-3}
    options = dict(loss_chunk=16)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jadam.AdamW(**opt_kw), jsteps.baseline_rules(jmesh.make_host_mesh()),
        jsteps.StepOptions(**options)))
    tstep = tsteps.make_train_step(
        tcfg, tadam.AdamW(**opt_kw), tsteps.baseline_rules(tmesh.make_host_mesh([CPU])),
        tsteps.StepOptions(**options))
    jds = JaxDataset(jcfg.vocab_size, SEQ, BATCH, seed=5)
    tds = SyntheticDataset(tcfg.vocab_size, SEQ, BATCH, seed=5)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jadam.AdamW(**opt_kw).init(jparams)
    tparams = params_from_numpy(jp, CPU)
    tstate = tadam.AdamW(**opt_kw).init(tparams)
    for step in range(4):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(step, jnp.int32),
                                    jax.tree.map(jnp.asarray, jds.batch(step)))
        tparams, tstate, tm = tstep(tparams, tstate, step, tds.device_batch(step, CPU))
        assert set(tm) == {"loss", "ce", "aux", "grad_norm"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TRAJ_RTOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=TRAJ_RTOL, err_msg=f"step {step}")


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step,frontend", [(0, 0, 0), (0, 3, 0), (7, 1, 0), (2, 0, 4)])
def test_synthetic_batches_equal_jax(seed, step, frontend):
    kw = dict(vocab_size=512, seq_len=16, batch_size=3, seed=seed, frontend_tokens=frontend,
              d_model=8)
    ref, got = JaxDataset(**kw).batch(step), SyntheticDataset(**kw).batch(step)
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    dev = SyntheticDataset(**kw).device_batch(step, CPU)
    assert dev["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(dev["labels"].numpy(), ref["labels"])


# ------------------------------------------------------------ checkpoints

def _ckpt_tree():
    rng = np.random.default_rng(4)
    return {"params": {"embed": rng.standard_normal((6, 4)).astype(jnp.bfloat16),
                       "blocks": {"layer0": {"w": rng.standard_normal((2, 4, 4))
                                             .astype(np.float32)}}},
            "opt_state": {"mu": {"w": rng.standard_normal(5).astype(np.float32)},
                          "count": np.arange(3, dtype=np.int32)}}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    tree = _ckpt_tree()
    jckpt.save_checkpoint(str(tmp_path), 7, jax.tree.map(jnp.asarray, tree))
    assert tckpt.latest_step(str(tmp_path)) == 7
    step, got = tckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert step == 7
    assert got["params"]["embed"].dtype == torch.bfloat16
    ref, back = _flat(tree), _flat(params_to_numpy(got))
    assert ref.keys() == back.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], _bits(ref[k]), err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = params_from_numpy(_ckpt_tree(), CPU)
    tckpt.save_checkpoint(str(tmp_path), 3, tree)
    tckpt.save_checkpoint(str(tmp_path), 12, tree)
    step, got = jckpt.load_checkpoint(str(tmp_path))
    assert step == 12 and got["params"]["embed"].dtype == jnp.bfloat16
    ref = _flat(params_to_numpy(tree))
    for k, a in _flat(jax.tree.map(np.asarray, got)).items():
        np.testing.assert_array_equal(_bits(a), ref[k], err_msg=k)


def test_resume_from_a_jax_run_matches_jax_resume(tmp_path):
    """``repro.launch.train`` trains 2 steps of bf16 qwen2-smoke and
    checkpoints; both launchers resume from a copy of that checkpoint for
    steps 2 and 3."""
    common = ["--smoke", "--batch", "2", "--seq", "32"]
    first = str(tmp_path / "jax")
    jtrain.main([*common, "--steps", "2", "--ckpt-dir", first, "--ckpt-every", "2"])
    second = str(tmp_path / "port")
    shutil.copytree(first, second)
    ref = jtrain.main([*common, "--steps", "4", "--ckpt-dir", first, "--resume"])
    got = ttrain.main([*common, "--steps", "4", "--ckpt-dir", second, "--resume",
                       "--device", "cpu"])
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESUME_BF16_ATOL)


# --------------------------------------------------------------- launcher

def test_train_cli_on_cpu_learns_and_records_telemetry(tmp_path, capsys):
    """The port's launcher on the CPU: the loss falls, a checkpoint is
    written, and ``repro``'s ``MeasurementStore`` reads the step records."""
    telem = str(tmp_path / "telem")
    losses = ttrain.main(["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
                          "--seq", "32", "--lr", "3e-3", "--telemetry-dir", telem,
                          "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3"])
    out = capsys.readouterr().out
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "step     0 loss=" in out and " gnorm=" in out and "done: 6 steps" in out
    assert tckpt.latest_step(str(tmp_path / "ck")) == 6
    recs = JaxMeasurementStore(telem).records()
    assert [r.step for r in recs] == list(range(6))
    assert all(r.wall_time > 0 and r.meta["launcher"] == "train" for r in recs)
    assert recs[0].meta["arch"] == "qwen2-1.5b"


@pytest.mark.parametrize("flag", ["--run-id", "--spool-dir", "--trace-dir", "--xla-profile"])
def test_train_cli_refuses_unported_flags(flag, tmp_path, capsys):
    """The flags of ``repro``'s launcher that earlier slices of the port
    refused now run, as ``repro``'s do: ``--run-id`` names the run in the
    telemetry records; ``--spool-dir`` writes an anchored shard of this
    process with one span a step, carrying its loss; ``--trace-dir`` with
    ``--tag-search`` (whose search records the spans) writes a valid
    ``trace_spans.json``; ``--xla-profile`` runs step 1 once under
    torch.profiler, whose trace it writes and parses (no collective on one
    CPU), and the losses equal an unprofiled run's."""
    from repro.obs.trace import validate_chrome_trace
    from repro_torch.obs.torch_profiler import find_trace_files
    telem = tmp_path / "telem"
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--telemetry-dir", str(telem)]
    if flag == "--run-id":
        ttrain.main([*base, "--run-id", "r7"])
        assert [r.meta["run_id"] for r in JaxMeasurementStore(str(telem)).records()] == ["r7"] * 2
    elif flag == "--spool-dir":
        losses = ttrain.main([*base, "--spool-dir", str(tmp_path / "spool")])
        (shard,) = (tmp_path / "spool").iterdir()
        assert shard.name.startswith("train-qwen2-1.5b--train-")
        recs = [json.loads(line) for line in shard.read_text().splitlines()]
        assert recs[0]["type"] == "anchor" and recs[0]["meta"] == {"arch": "qwen2-1.5b"}
        spans = [r for r in recs if r["type"] == "span"]
        assert [r["name"] for r in spans] == ["step 0", "step 1"]
        assert [r["args"]["loss"] for r in spans] == losses
    elif flag == "--trace-dir":
        ttrain.main([*base, "--trace-dir", str(tmp_path / "tr"), "--tag-search",
                     "--pipeline", "off"])
        with open(tmp_path / "tr" / "trace_spans.json") as f:
            doc = validate_chrome_trace(json.load(f))
        assert {"playout", "simulate"} <= {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    else:
        ref = ttrain.main(base)
        got = ttrain.main([*base, "--xla-profile"])
        out = capsys.readouterr().out
        assert got == ref
        assert 'xla-profile: {"profiler": "ok"' in out and '"n_collectives": 0' in out
        assert len(find_trace_files(str(telem / "torch_profile"))) == 1
        recs = JaxMeasurementStore(str(telem)).records()
        assert len(recs) == 4 and recs[3].collectives == [] and recs[3].wall_time > 0


@pytest.mark.parametrize("flag,value,want", [
    ("--n-chunks", "3", "[pipeline interleaved x2x3v]"),
    ("--engine", "eager", "pipeline engine: eager"),
    ("--engine", "scan", "pipeline engine: scan (uncaptured on cpu, unroll=1)"),
    ("--scan-unroll", "3", "pipeline engine: scan (uncaptured on cpu, unroll=3)"),
])
def test_train_cli_accepts_pipeline_flags(flag, value, want, capsys):
    """The pipeline flags: the launcher accepts them, and ``run_pipeline``,
    given the launcher's own parse of them, runs what they ask for.
    ``--n-chunks 3`` under the interleaved schedule gives 3 virtual stages
    on each of 2 stages (the ``x2x3v`` log tag); ``--engine`` picks the
    engine that runs (the compiled one uncaptured on the CPU);
    ``--scan-unroll`` sets its microbatch bodies a loop."""
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "0", flag, value])
    assert "done: 1 steps" in capsys.readouterr().out
    cfg = ttrain.get_reduced("qwen2-1.5b").replace(dtype="float32", num_layers=6)
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "8", "--seq", "16",
            "--pipeline", "interleaved", flag, value]
    if flag == "--scan-unroll":
        argv += ["--engine", "scan"]
    losses = ttrain.run_pipeline(ttrain.parse_args(argv), cfg, _pipe_plan().stage_plan,
                                 [CPU, CPU])
    out = capsys.readouterr().out
    assert want in out
    assert ("[pipeline interleaved x2x3v]" if flag == "--n-chunks"
            else "[pipeline interleaved x2x2v]") in out
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_train_cli_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--tag-search", "--steps", "1"])


def test_train_cli_tag_search_plans_then_trains(capsys):
    """``--tag-search`` on the CPU: the TAG plan over an H100 cluster is
    printed, a plan that pipelines falls back to the one device with the
    explicit warning, and the configured model trains."""
    losses = ttrain.main(["--smoke", "--device", "cpu", "--tag-search", "--steps", "2",
                          "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "TAG plan: speedup=" in out and "summary=" in out
    assert " groups, simulated " in out
    plan_line = next(line for line in out.splitlines() if line.startswith("TAG plan:"))
    if '"n_stages": 0' not in plan_line:
        assert "WARNING: TAG pipeline fallback" in out
    assert "training qwen2-smoke" in out
    assert len(losses) == 2 and all(np.isfinite(losses))


def _pipe_plan():
    """A lowered plan whose PIPE actions span two H100 nodes: two stages."""
    from repro_torch.core.device import h100_nodes
    from repro_torch.core.graph import CompGraph, OpNode, group_graph
    from repro_torch.core.plan import lower_strategy
    from repro_torch.core.strategy import Action, Option, Strategy
    g = CompGraph(name="chain")
    for i in range(8):
        g.add_node(OpNode(i, f"op{i}", "mm", flops=1e9, bytes_out=1e6, param_bytes=4e5,
                          grad_bytes=4e5, is_grad_producer=True))
        if i:
            g.add_edge(i - 1, i, 1e6)
    gg = group_graph(g, {i: i // 2 for i in range(8)})
    strat = Strategy([Action((0, 1), Option.PIPE if i % 2 == 0 else Option.PS)
                      for i in range(gg.n)])
    plan = lower_strategy(strat, gg, h100_nodes())
    assert plan.stage_plan is not None and plan.stage_plan.n_stages == 2
    return plan


@pytest.mark.parametrize("mode", ["auto", "gpipe", "1f1b", "interleaved", "zb"])
def test_pipelined_plan_runs_where_it_has_the_devices(mode, capsys):
    """Where the run has as many devices as stages, ``resolve_pipeline``
    returns the ``StagePlan`` to execute and says so."""
    plan = _pipe_plan()
    assert ttrain.resolve_pipeline(plan, mode, [CPU, CPU]) is plan.stage_plan
    sched = plan.stage_plan.schedule if mode == "auto" else mode
    assert f"executing 2 stages (schedule={sched}" in capsys.readouterr().out


def test_pipelined_plan_falls_back_without_the_devices(capsys):
    plan = _pipe_plan()
    assert ttrain.resolve_pipeline(plan, "zb", [CPU]) is None
    assert "WARNING: TAG pipeline fallback" in capsys.readouterr().out
    assert ttrain.resolve_pipeline(plan, "off", [CPU, CPU]) is None
    assert "--pipeline off" in capsys.readouterr().out


def test_engine_scan_still_raises():
    """The compiled engine takes a stage whose shards sit on distinct CUDA
    devices, or mix the CPU and a card, without touching a device at
    construction; where those cards are missing its step still raises, and
    nothing falls back to the CPU. A stage's shards on the CPU run."""
    from repro_torch.exec import CompiledPipelineRunner, split_model
    from repro_torch.models.model import init_params
    cfg = ttrain.get_reduced("qwen2-1.5b").replace(dtype="float32")
    sp, fns, keys, tied = split_model(
        cfg, init_params(cfg, torch.Generator().manual_seed(0), CPU), 2)
    plan = _pipe_plan().stage_plan
    cuda = [torch.device("cuda", i) for i in range(4)]
    batch = {k: torch.zeros((8, 16), dtype=torch.long) for k in ("tokens", "labels")}
    for sets in ([cuda[:2], cuda[2:]], [[CPU, cuda[0]], [CPU, CPU]]):
        runner = CompiledPipelineRunner(fns, plan, sets, mb_keys=keys, tied_ref=tied)
        assert runner._seed is None and not runner._graphs and not runner._pools
        assert runner.device_sets == sets
        if max(d.index for s in sets for d in s if d.type == "cuda") >= torch.cuda.device_count():
            with pytest.raises((RuntimeError, AssertionError)):
                runner.step(runner.place_params(sp), batch)
            assert not runner._graphs
    runner = CompiledPipelineRunner(fns, plan, [[CPU, CPU], [CPU, CPU]], mb_keys=keys,
                                    tied_ref=tied)
    grads, stats = runner.step(runner.place_params(sp), batch)
    assert len(grads) == 2 and stats.peak_stash == 2 * plan.n_micro


def test_instrumented_step_times_each_call():
    from repro_torch.runtime.telemetry import MeasurementStore, StepTimer
    timer = StepTimer(MeasurementStore(), meta={"arch": "x"})
    fn = tsteps.instrument_step(lambda a: a + 1, timer)
    assert fn(torch.ones(2)).tolist() == [2.0, 2.0] and fn(torch.zeros(1)).tolist() == [1.0]
    assert timer.summary()["steps"] == 2 and len(timer.wall_times) == 2
