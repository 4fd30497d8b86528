"""Port parity, pipeline execution: ``repro_torch.exec.PipelineRunner`` against
``repro.exec.PipelineRunner`` and against the port's single-device gradient,
on reduced qwen2-1.5b (tied head) and mamba2-130m (untied head), f32, CPU;
and, in ``FAMILY_CASES``, the other model families: olmoe and musicgen
(its frontend prefix on stage 0) under 1f1b and zb with AR and 2 shards a
stage, and jamba (4 layers: one Mamba and one attention layer with an MoE
FFN a stage) under 1f1b. Each shard of a stage routes its MoE layers as one
group with its own aux loss, as ``repro``'s stages under ``shard_map`` do,
so an MoE pipeline's single-device reference is the mean of ``loss_fn``
over the engine's row blocks (a microbatch's rows on one shard), each
routed alone; at capacity factor 0.5 every shard drops assignments (2 x 32
of them into 4 experts of 8 slots).

``repro``'s engine runs once for this module, in a subprocess with four
forced host devices (as ``tests/test_exec.py`` runs it), over every case
below; it writes its parameters, losses, gradients, ``peak_stash`` and event
lists to an npz. The port runs the same cases in-process on ``[cpu] * k``,
from those parameters (``models.convert.params_from_numpy``) and the same
numpy batch drawn from a seed.

The cases: gpipe, 1f1b and zb on 2 stages; interleaved on 2 x 2 virtual
stages; AR, PS and SFB with 2-way stage data parallelism under 1f1b and zb.

Tolerances: loss and every gradient leaf 1e-4 absolute, the tolerance of
``tests/test_exec.py``; ``peak_stash`` and the event order exactly.

Mamba runs at sequence 64 in chunks of 32, where ``repro``'s ``ssd_chunked``
keeps finite gradients (see test_torch_ssm.py).
"""
import argparse
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
from repro_torch.exec import PipelineRunner, StagePlan, StageSpec, split_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import loss_fn
from repro_torch.optim.adam import from_leaves, leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("qwen2-1.5b", "mamba2-130m")
SEQ = {"qwen2-1.5b": 16, "mamba2-130m": 64, "olmoe-1b-7b": 16, "musicgen-large": 16,
       "jamba-v0.1-52b": 32}
BATCH, BATCH_SEED = 8, 11
TOL = 1e-4
# (schedule, sync, devices a stage, n_micro, chunks a stage)
CASES = {
    "gpipe": ("gpipe", "allreduce", 1, 4, 1),
    "1f1b": ("1f1b", "allreduce", 1, 4, 1),
    "zb": ("zb", "allreduce", 1, 4, 1),
    "interleaved": ("interleaved", "allreduce", 1, 4, 2),
    "1f1b-ar-dp2": ("1f1b", "allreduce", 2, 2, 1),
    "1f1b-ps-dp2": ("1f1b", "ps", 2, 2, 1),
    "1f1b-sfb-dp2": ("1f1b", "sfb", 2, 2, 1),
    "zb-ar-dp2": ("zb", "allreduce", 2, 2, 1),
    "zb-ps-dp2": ("zb", "ps", 2, 2, 1),
    "zb-sfb-dp2": ("zb", "sfb", 2, 2, 1),
}
PEAK_STASH = {"gpipe": 8, "1f1b": 3, "zb": 3}
FAMILY_CASES = [("olmoe-1b-7b", "1f1b-ar-dp2"), ("olmoe-1b-7b", "zb-ar-dp2"),
                ("musicgen-large", "1f1b-ar-dp2"), ("musicgen-large", "zb-ar-dp2"),
                ("jamba-v0.1-52b", "1f1b-ar-dp2")]
KINDS = "FBW"
CPU = torch.device("cpu")


def _cfg_kw(arch):
    return {"mamba2-130m": {"ssm_chunk": 32}, "olmoe-1b-7b": {"capacity_factor": 0.5},
            "jamba-v0.1-52b": {"ssm_chunk": 32, "num_layers": 4, "capacity_factor": 0.5},
            }.get(arch, {})


def _prefix(cfg) -> tuple:
    """The shape of a row's frontend prefix, () without a frontend."""
    return (cfg.frontend_tokens, cfg.d_model) if cfg.frontend != "none" else ()


def _batch(vocab: int, seq: int, prefix: tuple = ()) -> dict:
    rng = np.random.default_rng(BATCH_SEED)
    out = {"tokens": rng.integers(0, vocab, (BATCH, seq)).astype(np.int32),
           "labels": rng.integers(0, vocab, (BATCH, seq)).astype(np.int32)}
    if prefix:
        out["prefix"] = rng.standard_normal((BATCH, *prefix)).astype(np.float32)
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) if v.dtype == np.float32 else torch.as_tensor(v).long()
            for k, v in batch.items()}


def _plan(n_micro, sync="allreduce", n_devices=1):
    return {"stages": [{"stage_id": i, "device_group": i, "op_group_ids": [i], "flops": 1e9,
                        "param_bytes": 0, "grad_bytes": 0, "out_bytes": 1e5, "sync": sync,
                        "n_devices": n_devices, "gpu_type": "V100"} for i in range(2)],
            "placement": [0, 1], "n_micro": n_micro}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


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
import jax
from repro.configs import get_reduced
from repro.exec import PipelineRunner, split_model
from repro.exec.stages import StagePlan
from repro.models import init_params
from repro.runtime.telemetry import MeasurementStore
sys.path.insert(0, {test_dir!r})
from test_torch_pipeline import (
    CASES, KINDS, SEQ, _batch, _cfg_kw, _flatten, _plan, _prefix)

devs = jax.devices()
assert len(devs) == 4, devs
res = {{}}
arch, names = sys.argv[2], sys.argv[3:]
cfg = get_reduced(arch).replace(dtype="float32", **_cfg_kw(arch))
params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
for k, v in _flatten(params).items():
    res[f"{{arch}}/params/{{k}}"] = v
batch = _batch(cfg.vocab_size, SEQ[arch], _prefix(cfg))
for name in names:
    sched, sync, n, n_micro, V = CASES[name]
    plan = StagePlan.from_dict(_plan(n_micro, sync, n))
    splits = plan.layer_splits(cfg.num_periods, n_chunks=V)
    sp, fns, keys, tied = split_model(cfg, params, 2 * V, splits=splits)
    sets = [[devs[0]], [devs[1]]] if n == 1 else [devs[:2], devs[2:]]
    store = MeasurementStore()
    runner = PipelineRunner(fns, plan, sets, schedule=sched, n_micro=n_micro,
                            n_chunks=V, mb_keys=keys, tied_ref=tied, store=store)
    grads, stats = runner.step(runner.place_params(sp), batch, record=True)
    pre = f"{{arch}}/{{name}}"
    res[pre + "/loss"] = np.float64(stats.loss)
    res[pre + "/ce"] = np.float64(stats.metrics["ce"])
    res[pre + "/peak_stash"] = np.int64(stats.peak_stash)
    res[pre + "/events"] = np.array(
        [(KINDS.index(e[0]), e[1], e[2], e[4]) for e in stats.events], np.int64)
    res[pre + "/flops"] = np.array([c["flops"] for c in store.records()[-1].compute])
    for u, g in enumerate(grads):
        for k, v in _flatten(jax.tree.map(np.asarray, g)).items():
            res[f"{{pre}}/grad/{{u}}/{{k}}"] = v
np.savez(sys.argv[1], **res)
print("JAX_PIPELINE_OK")
"""


def _case_groups() -> list:
    """(arch, case names) a subprocess: every case of ``ARCHS`` by device
    layout, and each family arch's cases."""
    groups = [(arch, [c for c, v in CASES.items() if v[2] == n])
              for arch in ARCHS for n in (1, 2)]
    for arch in dict.fromkeys(a for a, _ in FAMILY_CASES):
        groups.append((arch, [c for a, c in FAMILY_CASES if a == arch]))
    return groups


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """``repro``'s results for every case: one subprocess an arch and device
    layout (one device a stage, or two), all started together."""
    tmp = tmp_path_factory.mktemp("jaxpipe")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_SCRIPT.format(
        test_dir=os.path.dirname(os.path.abspath(__file__))))
    groups = _case_groups()
    outs = [str(tmp / f"{i}.npz") for i in range(len(groups))]
    procs = [subprocess.Popen([sys.executable, "-c", code, out, arch, *names], env=env,
                              text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for (arch, names), out in zip(groups, outs)]
    res = {}
    for proc, out in zip(procs, outs):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "JAX_PIPELINE_OK" in stdout, stderr[-3000:]
        with np.load(out) as f:
            res.update({k: f[k] for k in f.files})
    return res


def _of(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


_SETUPS: dict = {}


def _setup(jax_results, arch, blocks: int = 1):
    """The port's config, the JAX parameters as tensors, the batch, and the
    port's own single-device loss and gradient: the mean of ``loss_fn`` over
    ``blocks`` equal row blocks of the batch (made once an arch and block
    count)."""
    if (arch, blocks) not in _SETUPS:
        cfg = get_reduced(arch).replace(dtype="float32", **_cfg_kw(arch))
        params = params_from_numpy(_unflatten(_of(jax_results, f"{arch}/params/")), CPU)
        batch = _torch_batch(_batch(cfg.vocab_size, SEQ[arch], _prefix(cfg)))
        ps = [t.clone().requires_grad_(True) for t in leaves(params)]
        rows = BATCH // blocks
        loss = sum(loss_fn(cfg, from_leaves(params, ps),
                           {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()},
                           remat=False)[0] for i in range(blocks)) / blocks
        ref = from_leaves(params, list(torch.autograd.grad(loss, ps)))
        _SETUPS[arch, blocks] = (cfg, params, batch, float(loss.detach()), ref)
    return _SETUPS[arch, blocks]


def _slice(tree, lo, hi):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _run_port(cfg, params, batch, name, record=True, store=None):
    sched, sync, n, n_micro, V = CASES[name]
    plan = StagePlan.from_dict(_plan(n_micro, sync, n))
    splits = plan.layer_splits(cfg.num_periods, n_chunks=V)
    sp, fns, keys, tied = split_model(cfg, params, 2 * V, splits=splits)
    runner = PipelineRunner(fns, plan, [[CPU] * n, [CPU] * n], schedule=sched, n_micro=n_micro,
                            n_chunks=V, mb_keys=keys, tied_ref=tied, store=store)
    grads, stats = runner.step(runner.place_params(sp), batch, record=record)
    return grads, stats, splits


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_matches_repro_and_single_device(jax_results, arch, name, tmp_path):
    _check_case(jax_results, arch, name, tmp_path)


@pytest.mark.parametrize("arch,name", FAMILY_CASES)
def test_pipeline_families_match_repro(jax_results, arch, name, tmp_path):
    """MoE, hybrid and frontend models through the engine: ``repro``'s
    numbers, and the single device's (for an MoE model, over the engine's
    row blocks)."""
    _check_case(jax_results, arch, name, tmp_path)


def _check_case(jax_results, arch, name, tmp_path):
    from repro.runtime.telemetry import MeasurementStore as JaxMeasurementStore
    from repro_torch.runtime.telemetry import MeasurementStore
    _, _, n, n_micro, _ = CASES[name]
    moe = get_reduced(arch).num_experts > 0
    cfg, params, batch, ref_loss, ref = _setup(jax_results, arch, n * n_micro if moe else 1)
    store = MeasurementStore(str(tmp_path))
    grads, stats, splits = _run_port(cfg, params, batch, name, store=store)
    pre = f"{arch}/{name}"
    assert abs(stats.loss - float(jax_results[pre + "/loss"])) < TOL
    assert abs(stats.loss - ref_loss) < TOL
    assert abs(stats.metrics["ce"] - float(jax_results[pre + "/ce"])) < TOL
    sched = CASES[name][0]
    assert stats.peak_stash == int(jax_results[pre + "/peak_stash"])
    if sched in PEAK_STASH:
        assert stats.peak_stash == PEAK_STASH[sched]
    events = np.array([(KINDS.index(e[0]), e[1], e[2], e[4]) for e in stats.events])
    np.testing.assert_array_equal(events, jax_results[pre + "/events"])
    flops = [c["flops"] for c in JaxMeasurementStore(str(tmp_path)).records()[-1].compute]
    np.testing.assert_allclose(flops, jax_results[pre + "/flops"], rtol=1e-12)

    U = len(splits)
    assert len(grads) == U
    for u, (lo, hi) in enumerate(splits):
        got = {k: v.numpy() for k, v in _flatten(grads[u]).items()}
        want = _of(jax_results, f"{pre}/grad/{u}/")
        assert sorted(got) == sorted(want), (u, sorted(got), sorted(want))
        mine = dict(_flatten({"blocks": _slice(ref["blocks"], lo, hi)}))
        if u == 0:
            mine["embed"] = ref["embed"]
            if "frontend_proj" in ref:
                mine["frontend_proj"] = ref["frontend_proj"]
        if u == U - 1:
            mine["final_norm"] = ref["final_norm"]
            if "head" in ref:
                mine["head"] = ref["head"]
        assert sorted(mine) == sorted(got)
        for k, v in got.items():
            assert v.shape == want[k].shape, (u, k)
            if v.size:
                np.testing.assert_allclose(v, want[k], rtol=0, atol=TOL, err_msg=f"{u} {k}")
                np.testing.assert_allclose(v, mine[k].numpy(), rtol=0, atol=TOL,
                                           err_msg=f"{u} {k} vs single device")


def test_grad_sync_primitives_keep_repro_semantics():
    """AR: the sum on every shard; PS: reduce-scatter + all-gather with the
    padding cut off (a leaf of 7 elements over 3 owners); SFB is not a
    gradient sync; one device is the identity."""
    from repro_torch.parallel.sfb_dense import (
        SYNC_MODES, allreduce_grad, ps_grad, tree_grad_sync)
    rng = np.random.default_rng(0)
    shards = [torch.as_tensor(rng.standard_normal(7).astype(np.float32)) for _ in range(3)]
    total = shards[0] + shards[1] + shards[2]
    for got in (allreduce_grad(shards), ps_grad(shards, 3)):
        assert len(got) == 3
        for g in got:
            assert g.shape == (7,)
            torch.testing.assert_close(g, total, rtol=0, atol=0)
    trees = [{"a": {"w": s.reshape(7, 1)}, "b": s[:2]} for s in shards]
    synced = tree_grad_sync(trees, "ps", 3)
    assert [t["a"]["w"].shape for t in synced] == [(7, 1)] * 3
    torch.testing.assert_close(synced[2]["b"], total[:2], rtol=0, atol=0)
    assert tree_grad_sync(trees[:1], "ps", 1) == trees[:1]
    with pytest.raises(ValueError, match="sfb"):
        tree_grad_sync(trees, "sfb", 3)
    assert SYNC_MODES == ("allreduce", "ps", "sfb")


@pytest.mark.parametrize("sync", ["allreduce", "ps"])
@pytest.mark.parametrize("numel,n_dev", [(1, 4), (5, 4), (7, 3), (12, 3)])
def test_grad_sync_one_shard_equals_its_share_of_every_shard(sync, numel, n_dev):
    """``out=i`` (what the engine asks for: only the stage's first device
    uses the synced gradient) gives exactly shard ``i`` of the full sync,
    also where PS pads and where an owner's slice lies wholly in the
    padding."""
    from repro_torch.parallel.sfb_dense import tree_grad_sync
    rng = np.random.default_rng(numel)
    trees = [{"w": torch.as_tensor(rng.standard_normal(numel).astype(np.float32)),
              "n": {"b": torch.as_tensor(rng.standard_normal((numel, 2)).astype(np.float32))}}
             for _ in range(n_dev)]
    full = tree_grad_sync(trees, sync, n_dev)
    for i in range(n_dev):
        one = tree_grad_sync(trees, sync, n_dev, out=i)
        assert torch.equal(one["w"], full[i]["w"]) and torch.equal(one["n"]["b"], full[i]["n"]["b"])
    total = trees[0]["w"]
    for t in trees[1:]:
        total = total + t["w"]                   # shard order, as the sync sums
    assert torch.equal(full[0]["w"], total)
    assert tree_grad_sync(trees[:1], sync, 1, out=0) is trees[0]


def test_engine_refuses_what_repro_refuses():
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    from repro_torch.models.model import init_params
    from repro_torch.verify import PlanVerificationError
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    sp, fns, keys, tied = split_model(cfg, params, 4)
    plan = StagePlan.from_dict(_plan(4))
    with pytest.raises(ValueError, match="requires schedule='interleaved'"):
        PipelineRunner(fns, plan, [[CPU], [CPU]], schedule="1f1b", n_chunks=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        PipelineRunner(fns[:2], plan, [[CPU], [CPU]], spool=object())
    # interleaved at n_micro 3 over 2 stages: the preflight refuses the plan
    with pytest.raises((PlanVerificationError, ValueError)):
        PipelineRunner(fns, plan, [[CPU], [CPU]], schedule="interleaved", n_micro=3,
                       n_chunks=2)


def test_single_stage_split_matches_reference():
    """Degenerate 1-stage split: the composed stage fn applies the decoder
    blocks exactly once, with the tied head."""
    from repro_torch.models.model import init_params
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, 8))
    ref, _ = loss_fn(cfg, params, batch, remat=False)
    sp, fns, keys, tied = split_model(cfg, params, 1)
    assert tied is None and keys == [["tokens", "labels"]]
    loss, mets = fns[0](sp[0], None, batch)
    assert abs(float(loss) - float(ref)) < 1e-5 and set(mets) == {"ce", "aux"}


def test_stack_microbatches_shape_guard():
    from repro_torch.exec import split_microbatches, stack_microbatches
    batch = {"tokens": torch.arange(8 * 16).reshape(8, 16)}
    out = stack_microbatches(batch, 4)
    assert out["tokens"].shape == (4, 2, 16)
    for m, mb in enumerate(split_microbatches(batch, 4)):
        assert torch.equal(mb["tokens"], out["tokens"][m])
    with pytest.raises(ValueError, match="n_micro"):
        stack_microbatches(batch, 3)


# ---------------------------------------------------------------- launcher

def _hand_plan(schedule="zb", n_devices=2):
    return StagePlan(
        stages=[StageSpec(i, i, [i], flops=1e9, param_bytes=0, grad_bytes=0, out_bytes=1e5,
                          n_devices=n_devices, gpu_type="V100") for i in range(2)],
        placement=(0, 1), n_micro=4, schedule=schedule)


def _args(**kw):
    d = dict(arch="qwen2-1.5b", batch=8, seq=16, lr=1e-3, seed=0, steps=4, log_every=1,
             ckpt_dir="", ckpt_every=2, resume=False, pipeline="auto", n_micro=4, n_chunks=2,
             telemetry_dir="")
    d.update(kw)
    return argparse.Namespace(**d)


def test_pipeline_kill_and_resume_parity(tmp_path, capsys):
    """A pipelined run killed after 2 steps and resumed from its per-stage
    checkpoint gives the same losses and final checkpoint as an unbroken
    run (``tests/test_exec.py``'s test, on the port's ``run_pipeline``, with
    2-way stage data parallelism on a CPU device list)."""
    from repro_torch.checkpoint.ckpt import load_checkpoint
    from repro_torch.launch.train import run_pipeline
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    plan, devs = _hand_plan(), [CPU] * 4
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    telem = str(tmp_path / "telem")
    full = run_pipeline(_args(ckpt_dir=d1, telemetry_dir=telem), cfg, plan, devs)
    run_pipeline(_args(ckpt_dir=d2, steps=2), cfg, plan, devs)          # "killed"
    resumed = run_pipeline(_args(ckpt_dir=d2, resume=True), cfg, plan, devs)
    out = capsys.readouterr().out
    assert "resumed pipelined run from step 2" in out and "[pipeline zb x2]" in out
    assert len(full) == 4 and all(np.isfinite(full)) and full[-1] < full[0]
    np.testing.assert_allclose(full[2:], resumed, rtol=0, atol=1e-6)
    s1, t1 = load_checkpoint(d1, device="cpu")
    s2, t2 = load_checkpoint(d2, device="cpu")
    assert s1 == s2 == 4 and sorted(t1["params"]) == ["stage0", "stage1"]
    f1, f2 = _flatten(t1), _flatten(t2)
    assert sorted(f1) == sorted(f2)
    for k in f1:
        torch.testing.assert_close(f1[k], f2[k], rtol=0, atol=1e-6)
    # repro's MeasurementStore reads the port's pipeline records
    from repro.runtime.telemetry import MeasurementStore as JaxMeasurementStore
    recs = JaxMeasurementStore(telem).records()
    assert len(recs) == 4 and recs[0].meta["schedule"] == "zb"
    assert {(c["stage"], c["kind"]) for c in recs[0].compute} == {
        (s, k) for s in (0, 1) for k in "FBW"}
    # a per-stage checkpoint with another stage count is refused
    with pytest.raises(ValueError, match="not a 4-stage pipeline checkpoint"):
        run_pipeline(_args(ckpt_dir=d2, resume=True, pipeline="interleaved", steps=6),
                     cfg, plan, devs)


def test_run_pipeline_frees_its_tensors_without_the_garbage_collector(tmp_path):
    """No tensor of a pipelined run (steps, the optimizer, per-stage
    checkpoints) is left in a reference cycle: each is freed as soon as it
    is dropped, not when the garbage collector next runs, so one step's
    gradients do not linger into the next step's peak memory."""
    import gc
    from repro_torch.launch.train import run_pipeline
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    flags = gc.get_debug()
    gc.collect()
    gc.disable()
    try:
        run_pipeline(_args(steps=2, ckpt_dir=str(tmp_path)), cfg, _hand_plan(), [CPU] * 4)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [tuple(o.shape) for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic


def test_run_pipeline_interleaved_adjusts_n_micro(capsys):
    from repro_torch.launch.train import run_pipeline
    cfg = get_reduced("mamba2-130m").replace(dtype="float32", ssm_chunk=32)
    plan = _hand_plan("1f1b", n_devices=1)
    losses = run_pipeline(_args(arch="mamba2-130m", pipeline="interleaved", batch=6, n_micro=5,
                                seq=32, steps=2), cfg, plan, [CPU, CPU])
    out = capsys.readouterr().out
    assert "n_micro 5 -> 2" in out and "[pipeline interleaved x2x2v]" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="interleaved needs n_micro divisible"):
        run_pipeline(_args(pipeline="interleaved", batch=3, n_micro=3), cfg, plan, [CPU, CPU])


def test_train_launcher_pipeline_fallback(capsys):
    """A PIPE strategy is never silently degraded: on a host with too few
    devices the launcher prints the fallback warning; with enough it
    returns the StagePlan it will execute."""
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.launch.train import resolve_pipeline
    plan = ExecutionPlan(
        rules=None, grad_sync={}, zero1=False, summary={"options": {"PIPE": 3}},
        stage_plan=StagePlan(stages=[StageSpec(i, i, [i], 1e9, 0, 0, 1e5) for i in range(3)],
                             placement=(0, 1, 2), n_micro=4))
    assert resolve_pipeline(plan, "auto", [CPU]) is None      # 1 device < 3 stages
    out = capsys.readouterr().out
    assert "WARNING" in out and "fallback" in out
    assert resolve_pipeline(plan, "off", [CPU] * 3) is None
    assert "off" in capsys.readouterr().out
    assert resolve_pipeline(plan, "zb", [CPU] * 3) is plan.stage_plan
    assert "executing 3 stages (schedule=zb" in capsys.readouterr().out
    no_spine = ExecutionPlan(rules=None, grad_sync={}, zero1=False,
                             summary={"options": {"PIPE": 1}}, stage_plan=None)
    assert resolve_pipeline(no_spine, "auto", [CPU]) is None
    assert "single-mesh" in capsys.readouterr().out
