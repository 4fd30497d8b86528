"""Port parity, serving: ``repro_torch.launch.serve.generate`` against
``repro.launch.serve.generate`` from the same weights and prompts, plus the
port's ground rules (no JAX or ``repro`` import, no silent fall-back to the
CPU).

The greedy tokens must be identical in f32: the logits agree to about 1e-5
(tests/test_torch_models.py) while the top two logits of these random-weight
models lie much further apart.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
from repro.launch.serve import generate as jax_generate
from repro.parallel.sharding import AxisRules
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.device import resolve_device
from repro_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"


def _weights_and_prompts(B, P, seed=0, arch=ARCH):
    jcfg = jax_get_reduced(arch).replace(dtype="float32")
    tcfg = get_reduced(arch).replace(dtype="float32")
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), torch.device("cpu"))
    prompts = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, P))
    return jcfg, tcfg, jp, tp, prompts


@pytest.mark.parametrize("B,P,gen,seed", [(2, 8, 8, 0), (3, 5, 12, 1)])
def test_generate_gives_the_jax_tokens(B, P, gen, seed):
    jcfg, tcfg, jp, tp, prompts = _weights_and_prompts(B, P, seed)
    ref = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts, jnp.int32), gen, AxisRules()))
    stats: dict = {}
    out = tserve.generate(tcfg, tp, prompts, gen, stats=stats)
    assert out.shape == (B, gen) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)
    assert stats["decode_steps"] == gen
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("B,P,gen,seed", [(2, 8, 8, 0), (3, 5, 12, 1)])
def test_mamba_generate_gives_the_jax_tokens(B, P, gen, seed):
    """Reduced mamba2-130m: the prompt is stepped through ``mamba_decode``
    and the conv ring and SSM state carry it, in both packages."""
    jcfg, tcfg, jp, tp, prompts = _weights_and_prompts(B, P, seed, arch="mamba2-130m")
    ref = np.asarray(jax_generate(jcfg, jp, jnp.asarray(prompts, jnp.int32), gen, AxisRules()))
    out = tserve.generate(tcfg, tp, prompts, gen)
    assert out.shape == (B, gen) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)


def test_prefill_step_argmax_is_first_generated_token():
    """The fused prefill and the stepped prompt reach the same next token."""
    _, tcfg, _, tp, prompts = _weights_and_prompts(2, 16)
    logits = tsteps.make_prefill_step(tcfg.replace(attn_impl="pallas"), None)(
        tp, {"tokens": torch.from_numpy(prompts)})
    out = tserve.generate(tcfg, tp, prompts, 1)
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), out[:, 0].numpy())


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "generated (2, 4) tokens on cpu" in proc.stdout


def test_serve_cli_defaults_to_mamba():
    """Without ``--arch`` the launcher serves mamba2-130m, as ``repro``'s does."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "serving mamba2-smoke" in proc.stdout and "generated (2, 4) tokens on cpu" in proc.stdout


def test_resolve_device():
    """``cuda`` by default; without a card that raises and never falls back."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", ARCH, "--smoke", "--gen", "1"])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files[:-1]}
    assert {"optim/adam.py", "launch/steps.py", "launch/train.py", "data/synthetic.py",
            "checkpoint/ckpt.py", "runtime/telemetry.py", "models/ssm.py"} <= scanned
    # the planner: core/, exec/ and obs/
    assert {"core/graph.py", "core/partition.py", "core/device.py", "core/strategy.py",
            "core/profiler.py", "core/compiler.py", "core/simulator.py", "core/features.py",
            "core/fingerprint.py", "core/sfb.py", "core/mcts.py", "core/tag.py",
            "core/plan.py", "core/torch_export.py", "exec/__init__.py", "exec/stages.py",
            "exec/schedule.py", "obs/__init__.py", "obs/spans.py"} <= scanned
    # the pipeline: the verifier, the sync primitives, the engine and its launcher
    assert {"verify/__init__.py", "verify/diagnostics.py", "verify/hb.py", "verify/memory.py",
            "verify/collectives.py", "verify/placement.py", "verify/verifier.py",
            "verify/mutate.py", "parallel/sfb_dense.py", "exec/engine.py",
            "exec/model_split.py", "launch/mesh.py"} <= scanned
    # the planner service, runtime feedback and the GNN policy
    assert {"obs/metrics.py", "service/__init__.py", "service/fingerprint.py",
            "service/store.py", "service/warmstart.py", "service/registry.py",
            "service/planner.py", "service/cli.py", "runtime/__init__.py",
            "runtime/calibration.py", "runtime/drift.py", "runtime/executor.py",
            "runtime/feedback.py", "core/hetgnn.py", "core/trainer.py"} <= scanned
    # observability, the replay executor and the paper zoo
    assert {"obs/trace.py", "obs/collector.py", "obs/health.py", "obs/alerts.py",
            "obs/server.py", "obs/torch_profiler.py", "exec/replay.py", "core/zoo.py"} <= scanned
    # tensor parallelism, the dry run and the LR schedules
    assert {"parallel/tensor.py", "launch/dryrun.py", "core/step_analysis.py",
            "optim/schedule.py"} <= scanned
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
