"""Port parity, the compiled engine: ``repro_torch.exec.CompiledPipelineRunner``
against ``repro.exec.CompiledPipelineRunner`` and against the port's eager
engine, on reduced qwen2-1.5b (tied head) and mamba2-130m (untied head),
and on the other families' cases of ``tests/test_torch_pipeline.py``
(``FAMILY_CASES``: olmoe, musicgen, jamba), f32, CPU, where the compiled
engine's loops run uncaptured (on a card each is a CUDA graph:
``tests/test_torch_cuda.py``).

``repro``'s engine runs in four subprocesses with four forced host devices,
started together, over the cases of ``tests/test_torch_pipeline.py``
(gpipe, 1f1b, zb and interleaved on 2 stages; AR, PS and SFB with 2-way
stage data parallelism under 1f1b and zb), from one seed's parameters and
numpy batch, which the port takes over (``models.convert``).

Tolerances: loss, ``ce`` and every gradient leaf 1e-4 absolute, the
tolerance of ``tests/test_exec.py``; ``peak_stash`` and the event list
exactly; another ``unroll`` 1e-6 (the same microbatch bodies, grouped
otherwise in the gradient sum).
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

from test_torch_pipeline import (
    ARCHS, CASES, FAMILY_CASES, KINDS, SEQ, SRC, TOL, _args, _batch, _case_groups, _cfg_kw,
    _flatten, _hand_plan, _of, _plan, _prefix, _torch_batch, _unflatten)

from repro_torch.configs import get_reduced
from repro_torch.exec import (
    CompiledPipelineRunner, PipelineRunner, StagePlan, make_schedule, split_model)
from repro_torch.models.convert import params_from_numpy
from repro_torch.verify.memory import engine_peak_stash

CPU = torch.device("cpu")

_JAX_SCRIPT = """
import sys
import numpy as np
import jax
from repro.configs import get_reduced
from repro.exec import CompiledPipelineRunner, split_model
from repro.exec.stages import StagePlan
from repro.models import init_params
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
    runner = CompiledPipelineRunner(fns, plan, sets, schedule=sched, n_micro=n_micro,
                                    n_chunks=V, mb_keys=keys, tied_ref=tied)
    grads, stats = runner.step(runner.place_params(sp), batch, record=True)
    pre = f"{{arch}}/{{name}}"
    res[pre + "/loss"] = np.float64(stats.loss)
    res[pre + "/ce"] = np.float64(stats.metrics["ce"])
    res[pre + "/peak_stash"] = np.int64(stats.peak_stash)
    res[pre + "/events"] = np.array(
        [(KINDS.index(e[0]), e[1], e[2], e[4]) for e in stats.events], np.int64)
    for u, g in enumerate(grads):
        for k, v in _flatten(jax.tree.map(np.asarray, g)).items():
            res[f"{{pre}}/grad/{{u}}/{{k}}"] = v
np.savez(sys.argv[1], **res)
print("JAX_SCAN_OK")
"""


@pytest.fixture(scope="module")
def jax_scan(tmp_path_factory):
    """``repro``'s compiled engine on every case: one subprocess an arch and
    device layout, all started together."""
    tmp = tmp_path_factory.mktemp("jaxscan")
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
        assert proc.returncode == 0 and "JAX_SCAN_OK" in stdout, stderr[-3000:]
        with np.load(out) as f:
            res.update({k: f[k] for k in f.files})
    return res


def _runner(cls, cfg, params, name, **kw):
    sched, sync, n, n_micro, V = CASES[name]
    plan = StagePlan.from_dict(_plan(n_micro, sync, n))
    splits = plan.layer_splits(cfg.num_periods, n_chunks=V)
    sp, fns, keys, tied = split_model(cfg, params, 2 * V, splits=splits)
    runner = cls(fns, plan, [[CPU] * n, [CPU] * n], schedule=sched, n_micro=n_micro,
                 n_chunks=V, mb_keys=keys, tied_ref=tied, **kw)
    return runner, runner.place_params(sp)


def _grads_close(a_list, b_list, atol, what):
    assert len(a_list) == len(b_list)
    for u, (a, b) in enumerate(zip(a_list, b_list)):
        fa, fb = _flatten(a), _flatten(b)
        assert sorted(fa) == sorted(fb), (what, u)
        for k in fa:
            x = fa[k].numpy() if torch.is_tensor(fa[k]) else fa[k]
            y = fb[k].numpy() if torch.is_tensor(fb[k]) else fb[k]
            assert x.shape == y.shape, (what, u, k)
            if x.size:
                np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=f"{what} {u} {k}")


@pytest.mark.parametrize("arch,name", [(a, n) for a in ARCHS for n in CASES] + FAMILY_CASES)
def test_scan_engine_matches_repro_and_eager(jax_scan, arch, name):
    """The port's compiled engine against ``repro``'s and against the port's
    eager engine: loss, ``ce``, every gradient leaf, ``peak_stash`` (U x
    ``n_micro``: ``verify.memory``'s scan stash without its boundary buffer)
    and the events (one a loop, ``mb == -1``: 2U, 3U under zb)."""
    cfg = get_reduced(arch).replace(dtype="float32", **_cfg_kw(arch))
    params = params_from_numpy(_unflatten(_of(jax_scan, f"{arch}/params/")), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, SEQ[arch], _prefix(cfg)))
    scan, sp = _runner(CompiledPipelineRunner, cfg, params, name)
    grads, stats = scan.step(sp, batch, record=True)
    eager, ep = _runner(PipelineRunner, cfg, params, name)
    e_grads, e_stats = eager.step(ep, batch)
    pre = f"{arch}/{name}"
    assert abs(stats.loss - float(jax_scan[pre + "/loss"])) < TOL
    assert abs(stats.loss - e_stats.loss) < TOL
    assert abs(stats.metrics["ce"] - float(jax_scan[pre + "/ce"])) < TOL
    sched, _, _, M, V = CASES[name]
    U = 2 * V
    assert stats.peak_stash == int(jax_scan[pre + "/peak_stash"]) == U * M
    order = make_schedule(sched, 2, M, n_chunks=V)
    assert stats.peak_stash == sum(s - M for s in engine_peak_stash(order, M, engine="scan"))
    events = np.array([(KINDS.index(e[0]), e[1], e[2], e[4]) for e in stats.events])
    np.testing.assert_array_equal(events, jax_scan[pre + "/events"])
    assert len(events) == (3 if sched == "zb" else 2) * U and set(events[:, 2]) == {-1}
    want = [_unflatten(_of(jax_scan, f"{pre}/grad/{u}/")) for u in range(U)]
    _grads_close(grads, want, TOL, "repro")
    _grads_close(grads, e_grads, TOL, "eager")


@pytest.mark.parametrize("unroll", [2, 3, 4, 8])
def test_scan_unroll_keeps_the_gradients(unroll):
    """``unroll`` microbatch bodies a loop, a remainder where it does not
    divide ``n_micro`` (3 of 4), or more than ``n_micro`` (8): the gradients
    of ``unroll`` 1, the stash and the events unchanged."""
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, 16))
    base, bp = _runner(CompiledPipelineRunner, cfg, params, "zb")
    g1, s1 = base.step(bp, batch, record=True)
    r, rp = _runner(CompiledPipelineRunner, cfg, params, "zb", unroll=unroll)
    assert r._chunks() == ([(0, 4)] if unroll >= 4 else
                           [(0, 2), (2, 2)] if unroll == 2 else [(0, 3), (3, 1)])
    gk, sk = r.step(rp, batch, record=True)
    assert abs(sk.loss - s1.loss) < 1e-6 and sk.peak_stash == s1.peak_stash == 8
    assert [e[:3] for e in sk.events] == [e[:3] for e in s1.events]
    _grads_close(gk, g1, 1e-6, f"unroll {unroll}")


@pytest.mark.parametrize("unroll", [1, 2])
@pytest.mark.parametrize("sync", ["allreduce", "ps", "sfb"])
@pytest.mark.parametrize("sched", ["1f1b", "zb"])
def test_scan_engine_syncs_once_a_replay(monkeypatch, sched, sync, unroll):
    """Two shards a stage on ``[[CPU] * 2] * 2``, 4 microbatches: each loop
    runs one body a shard with work a replay (SFB's parameter gradient only
    on shard 0; zb's B of stage 0 has none) and one sync, or SFB gather, a
    replay where it gives a parameter gradient; the gradients are the eager
    engine's, 1e-4."""
    import repro_torch.exec.engine as engine_mod
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    from repro_torch.models.model import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    batch = _torch_batch(_batch(cfg.vocab_size, 16))
    M, n = 4, 2
    plan = StagePlan.from_dict(_plan(M, sync, n))
    sp, fns, keys, tied = split_model(cfg, params, 2)
    kw = dict(schedule=sched, n_micro=M, mb_keys=keys, tied_ref=tied)
    scan = CompiledPipelineRunner(fns, plan, [[CPU] * n] * 2, unroll=unroll, **kw)
    calls = []
    real = engine_mod.tree_grad_sync
    monkeypatch.setattr(engine_mod, "tree_grad_sync",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    grads, stats = scan.step(scan.place_params(sp), batch, record=True)
    monkeypatch.undo()
    replays = -(-M // unroll)
    sfb = sync == "sfb"
    want = {}
    for u in range(2):
        want[(u, "F")] = {"runs": n * replays, "syncs": 0}
        if sched == "zb":
            if u > 0:
                want[(u, "B")] = {"runs": n * replays, "syncs": 0}
            want[(u, "W")] = {"runs": (1 if sfb else n) * replays, "syncs": replays}
        else:
            want[(u, "B")] = {"runs": (1 if sfb and u == 0 else n) * replays,
                              "syncs": replays}
    assert scan.loop_counts == want
    n_syncs = sum(c["syncs"] for c in want.values())
    assert calls == ([] if sfb else [sync] * n_syncs)
    eager = PipelineRunner(fns, plan, [[CPU] * n] * 2, **kw)
    e_grads, e_stats = eager.step(eager.place_params(sp), batch)
    assert abs(stats.loss - e_stats.loss) < TOL
    assert len(stats.events) == (3 if sched == "zb" else 2) * 2
    _grads_close(grads, e_grads, TOL, f"{sched} {sync} unroll {unroll}")


def test_run_pipeline_scan_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``run_pipeline`` with ``engine="scan"`` and 2-way stage data
    parallelism on a CPU device list: the loss falls, a run killed after 2
    steps and resumed from its per-stage checkpoint gives the unbroken run's
    losses and final checkpoint, and the losses are the eager engine's."""
    from repro_torch.checkpoint.ckpt import load_checkpoint
    from repro_torch.launch.train import run_pipeline
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    plan, devs = _hand_plan("1f1b"), [CPU] * 4
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    scan = {"engine": "scan", "scan_unroll": 2}
    full = run_pipeline(_args(ckpt_dir=d1, **scan), cfg, plan, devs)
    run_pipeline(_args(ckpt_dir=d2, steps=2, **scan), cfg, plan, devs)      # "killed"
    resumed = run_pipeline(_args(ckpt_dir=d2, resume=True, **scan), cfg, plan, devs)
    eager = run_pipeline(_args(engine="eager"), cfg, plan, devs)
    out = capsys.readouterr().out
    assert ("pipeline engine: scan (uncaptured on cpu, unroll=2); stage 0 on cpu, cpu; "
            "stage 1 on cpu, cpu") in out
    assert "resumed pipelined run from step 2" in out and "[pipeline 1f1b x2]" in out
    assert len(full) == 4 and all(np.isfinite(full)) and full[-1] < full[0]
    np.testing.assert_allclose(full[2:], resumed, rtol=0, atol=1e-6)
    np.testing.assert_allclose(full, eager, rtol=0, atol=TOL)
    s1, t1 = load_checkpoint(d1, device="cpu")
    s2, t2 = load_checkpoint(d2, device="cpu")
    assert s1 == s2 == 4
    f1, f2 = _flatten(t1), _flatten(t2)
    assert sorted(f1) == sorted(f2)
    for k in f1:
        torch.testing.assert_close(f1[k], f2[k], rtol=0, atol=1e-6)
