"""Port parity, the dry run: ``repro_torch.launch.dryrun`` against
``repro.launch.dryrun`` on ``tests/test_parallel.py::test_dryrun_cli_small_mesh``'s
case, olmoe-1b-7b at ``decode_32k`` on a ``(2, 2)`` ``("data", "model")``
mesh (``repro``: four forced host devices, in a subprocess; the port:
``meta`` devices, nothing allocated), then the port's CLI on the
production mesh, and the H100 constants. The tensor-parallel cases follow
(``TP_CASES``): mamba2-130m x decode_32k on (2, 2), whose Mamba-2 mixers
split by heads; qwen2-1.5b x decode_32k on (1, 4), whose 2 KV heads are
replicated over their groups' positions, and on (1, 8) (``repro`` on 8
forced host devices), where its 12 query heads attend in 4 groups of 3,
each on 2 positions, as on the production mesh's 8. The FSDP cases
(``FSDP_CASES``, on (2, 2)) split parameters over ``"data"``: olmoe-1b-7b's
experts with ``expert_embed=data``, qwen2-1.5b's and mamba2-130m's leaves
with ``embed=data``, at ``decode_32k`` and qwen2-1.5b's at ``train_4k``;
``TRAIN_CASES`` hold the tensor-parallel train program without overrides
(qwen2-1.5b and mamba2-130m x train_4k on (2, 2)), and a production-mesh
case holds olmoe-1b-7b x train_4k with ``expert_embed=data`` to the
collectives that FSDP costs there. Every train_4k case runs at
``TRAIN_LAYERS`` on both packages (the port's mamba2-130m at full depth
takes minutes here; ``chip_smoke.py``'s dryrun phase runs qwen2-1.5b at
full depth against ``repro``'s constants).

Tolerances: the port's per-device matmul FLOPs within 1 % of ``repro``'s
``analyze_hlo`` (``tests/test_torch_zoo.py``'s tolerance); every position's
matmul FLOPs equal; the result dicts' keys equal; for ``TP_CASES`` the
port's collective wire bytes at most ``COLL_FACTOR`` times ``repro``'s (a
layer that ran gathered moved 60.6x and 3.9x); for ``FSDP_CASES`` within a
factor of ``COLL_FACTOR`` both ways, and argument bytes within
``ARG_RTOL`` of ``repro``'s for ``FSDP_CASES`` and ``TRAIN_CASES`` (the
moments in the parameters' dtype and the token ids in int32, as ``repro``
lowers them). Other bytes are not gated: eager PyTorch fuses nothing, so the port counts more HBM
traffic than XLA's fused module (``core/step_analysis.py``).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("jax")

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.telemetry import MeasurementStore

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
ARCH, SHAPE = "olmoe-1b-7b", "decode_32k"
FLOPS_RTOL = 0.01
TP_CASES = [("mamba2-130m", "decode_32k", (2, 2)), ("qwen2-1.5b", "decode_32k", (1, 4)),
            ("qwen2-1.5b", "decode_32k", (1, 8))]
COLL_FACTOR = 5.0
FSDP_CASES = [("olmoe-1b-7b", "decode_32k", {"expert_embed": "data"}),
              ("qwen2-1.5b", "decode_32k", {"embed": "data"}),
              ("mamba2-130m", "decode_32k", {"embed": "data"}),
              ("qwen2-1.5b", "train_4k", {"embed": "data"})]
TRAIN_CASES = [("qwen2-1.5b", "train_4k", None), ("mamba2-130m", "train_4k", None)]
TRAIN_LAYERS = {"num_layers": 2}
ARG_RTOL = 0.01


def _case_id(case) -> str:
    arch, shape, overrides = case
    return "-".join([arch, shape] + [f"{k}={v}" for k, v in (overrides or {}).items()])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k in ("xla_cost_analysis", "memory", "roofline",
                                          "collectives"):
            out |= {prefix + k + "." + kk for kk in v}
    return out


def _cfg_overrides(shape: str):
    return TRAIN_LAYERS if shape == "train_4k" else None


def _jax_lower(arch, shape, mesh_shape, overrides=None) -> subprocess.Popen:
    """``repro``'s ``lower_one`` of one case (a train_4k case at
    ``TRAIN_LAYERS``) on as many forced host devices as the mesh has, in a
    subprocess that prints ``DRY <json>``."""
    code = textwrap.dedent(f"""
        import json
        from repro.launch import mesh as mesh_mod
        from repro.launch.dryrun import lower_one
        mesh = mesh_mod.make_mesh({mesh_shape!r}, ("data", "model"))
        print("DRY", json.dumps(lower_one({arch!r}, {shape!r}, mesh, overrides={overrides!r},
                                          cfg_overrides={_cfg_overrides(shape)!r})))
    """)
    n = mesh_shape[0] * mesh_shape[1]
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _result(proc: subprocess.Popen) -> dict:
    stdout, stderr = proc.communicate(timeout=560)
    assert proc.returncode == 0, stderr[-2000:]
    line = next(ln for ln in stdout.splitlines() if ln.startswith("DRY "))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def jax_dry():
    return _result(_jax_lower(ARCH, SHAPE, (2, 2)))


@pytest.fixture(scope="module")
def jax_tp_dry():
    """``repro``'s results of ``TP_CASES``, the subprocesses started
    together."""
    procs = {c: _jax_lower(*c) for c in TP_CASES}
    return {c: _result(p) for c, p in procs.items()}


@pytest.fixture(scope="module")
def jax_fsdp_dry():
    """``repro``'s results of ``FSDP_CASES`` and ``TRAIN_CASES`` on (2, 2),
    the subprocesses started together."""
    procs = {_case_id(c): _jax_lower(c[0], c[1], (2, 2), c[2]) for c in FSDP_CASES + TRAIN_CASES}
    return {c: _result(p) for c, p in procs.items()}


@pytest.fixture(scope="module")
def port_dry():
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), [META] * 4)
    return tdry.lower_one(ARCH, SHAPE, mesh, with_stats=True)


def test_dryrun_small_mesh_matches_repro(jax_dry, port_dry):
    """The gate case on both packages: the same result keys, a positive
    temp size, non-negative roofline terms, per-device matmul FLOPs within
    1 % of ``repro``'s, every position's equal, and collectives with
    all-reduce bytes counted twice (the ring factor)."""
    got, stats = port_dry
    assert _keys(got) == _keys(jax_dry)
    assert got["memory"]["temp_bytes"] > 0 and got["roofline"]["compute_s"] >= 0
    assert all(v >= 0 for v in got["roofline"].values())
    assert abs(got["hlo_flops"] - jax_dry["hlo_flops"]) <= FLOPS_RTOL * jax_dry["hlo_flops"]
    per = stats.per_position_flops
    assert sorted(per) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len(set(per.values())) == 1
    coll = got["collectives"]
    assert coll["total_bytes"] > 0
    assert coll["total_bytes"] == pytest.approx(
        2 * coll["bytes"]["all-reduce"] + coll["bytes"].get("all-gather", 0.0))
    assert got["while_trips"] == [] and got["compile_s"] == 0.0
    assert got["mesh"] == "2x2" and got["n_chips"] == 4 and got["kind"] == "decode"
    assert (got["params"], got["active_params"]) == (jax_dry["params"], jax_dry["active_params"])
    assert got["dominant"] in got["roofline"]


@pytest.mark.parametrize("case", TP_CASES, ids=[f"{a}-{s}-{m[0]}x{m[1]}" for a, s, m in TP_CASES])
def test_dryrun_tensor_parallel_matches_repro(jax_tp_dry, case):
    """The layers that ``repro``'s program splits over ``"model"`` split in
    the port's too: mamba2-130m's mixers by heads (the convolved ``B|C``
    and the norm's sums of squares the only new collectives), qwen2-1.5b's
    attention with its 2 KV heads replicated over their groups (the K and V
    columns gathered) and, on 8 positions, its query heads in groups (q's
    columns gathered too). FLOPs a device within 1 % of ``repro``'s, every
    position's equal, collective wire bytes at most ``COLL_FACTOR`` times
    ``repro``'s."""
    arch, shape, mesh_shape = case
    want = jax_tp_dry[case]
    m = mesh_shape[1]
    mesh = tmesh.make_mesh(mesh_shape, ("data", "model"), [META] * (mesh_shape[0] * m))
    got, stats = tdry.lower_one(arch, shape, mesh, with_stats=True)
    assert abs(got["hlo_flops"] - want["hlo_flops"]) <= FLOPS_RTOL * want["hlo_flops"], (
        got["hlo_flops"], want["hlo_flops"])
    per = stats.per_position_flops
    assert len(per) == mesh_shape[0] * m and len(set(per.values())) == 1, per
    coll = got["collectives"]
    assert 0 < coll["total_bytes"] <= COLL_FACTOR * want["collectives"]["total_bytes"], (
        coll, want["collectives"])
    # position 0's collectives, a layer: mamba gathers its B|C and
    # all-reduces the norm's sums of squares and its out_proj partials;
    # qwen gathers K and V (and q where its heads do not divide) and
    # all-reduces the wo and MLP partials; beside them the embedding's
    # all-reduce and the logits' all-gather
    cfg = get_config(arch)
    L = cfg.num_layers
    if arch == "mamba2-130m":
        gathers, reduces = L, 2 * L
    else:
        gathers, reduces = (2 + (cfg.num_heads % m != 0)) * L, 2 * L
    assert coll["counts"] == {"all-gather": gathers + 1, "all-reduce": reduces + 1}


def _port_lower(case, mesh_shape=(2, 2)):
    arch, shape, overrides = case
    mesh = tmesh.make_mesh(mesh_shape, ("data", "model"), [META] * 4)
    return tdry.lower_one(arch, shape, mesh, overrides=overrides,
                          cfg_overrides=_cfg_overrides(shape), with_stats=True)


def _within(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * want


@pytest.mark.parametrize("case", FSDP_CASES, ids=[_case_id(c) for c in FSDP_CASES])
def test_dryrun_fsdp_matches_repro(jax_fsdp_dry, case):
    """Parameters split over ``"data"`` on (2, 2): each position all-gathers
    its row group's slices before a period (a decode step's every layer,
    the train step's forward and recompute) and the train step
    reduce-scatters their gradients. FLOPs a device within 1 % of
    ``repro``'s, every position's equal, collective wire bytes within a
    factor of ``COLL_FACTOR`` of ``repro``'s both ways, argument bytes (the
    slices a device holds) within ``ARG_RTOL``."""
    want = jax_fsdp_dry[_case_id(case)]
    got, stats = _port_lower(case)
    assert _within(got["hlo_flops"], want["hlo_flops"], FLOPS_RTOL), (
        got["hlo_flops"], want["hlo_flops"])
    per = stats.per_position_flops
    assert len(per) == 4 and len(set(per.values())) == 1, per
    mine, theirs = got["collectives"]["total_bytes"], want["collectives"]["total_bytes"]
    assert theirs / COLL_FACTOR <= mine <= COLL_FACTOR * theirs, (
        got["collectives"], want["collectives"])
    assert _within(got["memory"]["argument_bytes"], want["memory"]["argument_bytes"], ARG_RTOL), (
        got["memory"], want["memory"])
    counts = got["collectives"]["counts"]
    assert counts["all-gather"] > 0
    assert ("reduce-scatter" in counts) == (case[1] == "train_4k")


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[_case_id(c) for c in TRAIN_CASES])
def test_dryrun_train_matches_repro(jax_fsdp_dry, case):
    """The tensor-parallel train program on (2, 2) without overrides does
    ``repro``'s work: FLOPs a device within 1 % and every position's equal
    (no position recomputes a closing product under remat that ``repro``'s
    program does not), argument bytes within ``ARG_RTOL`` (the AdamW
    moments in the parameters' dtype, as ``repro`` lowers them)."""
    want = jax_fsdp_dry[_case_id(case)]
    got, stats = _port_lower(case)
    assert _within(got["hlo_flops"], want["hlo_flops"], FLOPS_RTOL), (
        got["hlo_flops"], want["hlo_flops"])
    per = stats.per_position_flops
    assert len(per) == 4 and len(set(per.values())) == 1, per
    assert _within(got["memory"]["argument_bytes"], want["memory"]["argument_bytes"], ARG_RTOL), (
        got["memory"], want["memory"])


def test_dryrun_fsdp_production_mesh_counts_its_collectives():
    """olmoe-1b-7b x train_4k with ``expert_embed=data`` on the 32 x 8
    production mesh, traced as one row of 8 positions that stands for 32:
    each position holds 1/32 of its 8 experts' rows and gathers the other
    31 from stand-ins, so its all-gather bytes exceed the baseline's on the
    same mesh by at least (1 - 1/32) of one column's expert weights in bf16
    (8 of 64 experts, 16 layers, ``w_gate``, ``w_up``, ``w_down``); the
    gradients of those leaves are reduce-scattered; a device's argument
    bytes fall below the baseline's."""
    cfg = get_config("olmoe-1b-7b")
    mesh = tmesh.make_production_mesh()
    base = tdry.lower_one("olmoe-1b-7b", "train_4k", mesh)
    fsdp = tdry.lower_one("olmoe-1b-7b", "train_4k", mesh, overrides={"expert_embed": "data"})
    m = mesh.shape["model"]
    experts = (cfg.num_experts // m) * cfg.num_layers * 3 * cfg.d_model * cfg.d_ff * 2
    extra = fsdp["collectives"]["bytes"]["all-gather"] - base["collectives"]["bytes"]["all-gather"]
    assert extra >= (1 - 1 / mesh.shape["data"]) * experts, (extra, experts)
    assert fsdp["collectives"]["counts"].get("reduce-scatter", 0) > 0
    assert "reduce-scatter" not in base["collectives"]["counts"]
    assert fsdp["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert fsdp["hlo_flops"] == base["hlo_flops"]


def test_dryrun_main_writes_results_and_telemetry(tmp_path):
    """``main`` on the production mesh (32 x 8, traced as one row of the
    data axis) writes a JSON list that ``benchmarks/roofline.py`` reads, and
    ``--telemetry-dir`` appends one ``StepRecord`` with ``launcher:
    "dryrun"``."""
    from benchmarks import roofline
    out, telem = tmp_path / "dry.json", tmp_path / "telem"
    rc = tdry.main(["--arch", ARCH, "--shape", SHAPE, "--out", str(out),
                    "--telemetry-dir", str(telem)])
    assert rc == 0
    rows = roofline.load_results([str(out)])
    assert len(rows) == 1 and rows[0]["ok"] and rows[0]["mesh"] == "32x8"
    assert rows[0]["n_chips"] == 256 and rows[0]["hlo_flops"] > 0
    assert roofline.main((str(out),))[0]["useful_ratio"] > 0
    recs = MeasurementStore(str(telem)).records()
    assert len(recs) == 1 and recs[0].meta["launcher"] == "dryrun"
    assert recs[0].wall_time == max(rows[0]["roofline"].values())


def test_production_mesh_and_h100_constants():
    """``make_production_mesh``: (32, 8) over ``("data", "model")``, 256
    positions; multi-pod (2, 32, 8), 512; ``meta`` by default. ``HW``: the
    H100 SXM5 data sheet."""
    m = tmesh.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.devices.shape == (32, 8)
    assert m.size == 256 and all(d == META for d in m.devices.flat)
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model") and mp.devices.shape == (2, 32, 8)
    assert mp.size == 512
    assert tmesh.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12, "ici_bw": 25e9,
                        "links_per_chip": 18, "hbm_bytes": 80e9}
    terms = tdry.roofline_terms(989e12, 3.35e12, 450e9, 256)
    assert terms == pytest.approx({"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0})
