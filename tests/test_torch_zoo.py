"""The paper's zoo (``repro_torch.core.zoo``) traced by the port's aten tracer
against ``repro``'s zoo traced by ``jax_export``, the tracer's
``convolution_backward`` rule, and the service CLI's zoo commands on both
packages.

At the paper's sizes (each builder's default batch), both packages' graphs:

- parameter nodes and the gradient bytes of their ApplyGradient nodes equal,
  leaf by leaf, in ``jax.tree.flatten``'s order (``repro``'s names sorted);
- forward convolution FLOPs equal to ``jax_export``'s forward pass (its
  jaxpr of the loss alone) within ``MATMUL_RTOL``, and the matmul FLOPs of
  the whole step within it too;
- the port's backward convolutions at twice the forward's, less the
  image's gradient, which nothing asks for. ``jax_export`` counts a
  transposed convolution's kernel as ``prod(rhs.shape[:-1])``, an HWIO
  assumption its backward convolutions do not keep, so its totals differ:
  forward plus backward convolution FLOPs at the paper's sizes are, ``repro``
  against the port, 10.954e15 against 11.220e15 (VGG19), 5.106e15 against
  4.337e15 (ResNet101) and 2.697e15 against 2.336e15 (Inception-v3);
- every convolution weight's gradient a SUM producer (``jax_export``'s too),
  every forward convolution, pooling, channel concat, spatial mean and
  residual add CONCAT with the batch on dim 0. ``jax_export`` hands the
  dense layers' weight gradients over through a ``transpose`` it marks
  OTHER, where the port's are SUM, as for the LMs (tests/test_torch_export.py).
"""
import contextlib
import functools
import io
import json
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import torch.nn.functional as F

from repro.core import jax_export, zoo as jzoo
from repro.core.graph import Split as JSplit
from repro.service import cli as rcli
from repro_torch.core import torch_export, zoo as tzoo
from repro_torch.core.graph import Split
from repro_torch.service import cli as tcli
from test_torch_obs import keys_of

MATMUL_RTOL = 0.01
CONV_NETS = ("vgg19", "resnet101", "inception_v3")
MATMULS = {"mm", "bmm", "addmm"}
BATCHED = {"convolution", "max_pool2d_with_indices", "max_pool2d_with_indices_backward",
           "cat", "add"}


@functools.cache
def graphs(name):
    """(JAX graph, torch graph, JAX forward conv FLOPs), unsimplified."""
    lf, p, b = jzoo.build(name)
    jg = jax_export.trace_training_graph(lf, p, b, name)
    ex = jax_export._Exporter(jax.tree.leaves(b)[0].shape[0])
    ex.walk(jax.make_jaxpr(lf)(p, b).jaxpr)
    fwd_conv = sum(n.flops for n in ex.g.nodes.values() if n.op_type == "conv_general_dilated")
    tlf, tp, tb = tzoo.build(name)
    tg = torch_export.trace_training_graph(tlf, tp, tb, name)
    return jg, tg, fwd_conv


def _leaves(g):
    params = sorted((n for n in g.nodes.values() if n.is_param),
                    key=lambda n: int(n.name.split("_")[1]))
    apply = {int(n.name.split("_")[-1]): n for n in g.nodes.values() if n.is_apply_grad}
    prod = {n.grad_of: n for n in g.nodes.values() if n.is_grad_producer}
    return [(p, apply[i], prod[apply[i].op_id]) for i, p in enumerate(params)]


def _flops(g, types) -> float:
    return sum(n.flops for n in g.nodes.values() if n.op_type in types)


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_params_match_repro_leaf_by_leaf(name):
    """The same leaves under the same names, element counts and dtypes,
    and the graphs' parameter and gradient bytes equal leaf by leaf."""
    _, jp, jb = jzoo.build(name)
    _, tp, tb = tzoo.build(name)
    assert sorted(jp) == sorted(tp) and sorted(jb) == sorted(tb)
    for tree_j, tree_t in ((jp, tp), (jb, tb)):
        for k in tree_j:
            assert math.prod(tree_j[k].shape) == tree_t[k].numel(), k
            assert str(tree_j[k].dtype) == str(tree_t[k].dtype).split(".")[-1], k
            assert tree_t[k].device.type == "meta"
    jg, tg, _ = graphs(name)
    jl, tl = _leaves(jg), _leaves(tg)
    assert len(jl) == len(tl) == len(jp)
    for (jpn, ja, jprod), (tpn, ta, tprod) in zip(jl, tl):
        assert tpn.param_bytes == jpn.param_bytes > 0
        assert ta.flops == ja.flops and ta.bytes_out == ja.bytes_out
        assert tprod.grad_bytes == jprod.grad_bytes == tpn.param_bytes


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_flops_match_repro(name):
    jg, tg, jax_fwd_conv = graphs(name)
    assert _flops(tg, MATMULS) == pytest.approx(_flops(jg, {"dot_general"}), rel=MATMUL_RTOL)
    fwd = _flops(tg, {"convolution"})
    assert fwd == pytest.approx(jax_fwd_conv, rel=MATMUL_RTOL)
    if name not in CONV_NETS:
        assert fwd == jax_fwd_conv == 0
        return
    # the convolutions that read the image: its gradient is never asked for
    inputs = {n.op_id for n in tg.nodes.values() if n.name.startswith("input_")}
    first = sum(n.flops for n in tg.nodes.values() if n.op_type == "convolution"
                and any(s in inputs for s in tg.preds(n.op_id)))
    assert 0 < first < fwd
    assert _flops(tg, {"convolution_backward"}) == 2 * fwd - first


@pytest.mark.parametrize("name", CONV_NETS)
def test_conv_nets_split_as_repro(name):
    jg, tg, _ = graphs(name)
    tprods = [n for n in tg.nodes.values() if n.is_grad_producer]
    jprods = [n for n in jg.nodes.values() if n.is_grad_producer]
    assert len(tprods) == len(jprods)
    assert all(n.split == Split.SUM and not n.batch_dim for n in tprods)
    t_conv = [n for n in tprods if n.op_type == "convolution_backward"]
    j_conv = [n for n in jprods if n.op_type == "conv_general_dilated"]
    assert len(t_conv) == len(j_conv) == sum(1 for p in tzoo.build(name)[1].values()
                                               if p.dim() == 4)
    assert all(n.split == JSplit.SUM for n in j_conv)
    assert sum(n.grad_bytes for n in t_conv) == sum(n.grad_bytes for n in j_conv)
    for n in tg.nodes.values():
        if n.op_type in BATCHED or (n.op_type == "mean" and n.flops > 0 and n.batch_dim):
            assert n.split == Split.CONCAT and n.batch_dim, (n.name, n.split)
    means = [n for n in tg.nodes.values() if n.op_type == "mean" and n.batch_dim]
    assert len(means) == (0 if name == "vgg19" else 1)


def test_convolution_backward_makes_sum_producers_with_the_forward_flops():
    """A two-layer conv net: each weight's gradient comes from its own
    ``convolution_backward`` node, a SUM producer with no batch dim whose
    FLOPs equal its layer's forward convolution's; the second layer's input
    gradient keeps the batch (CONCAT) at the same FLOPs; the first layer's
    input (the image) gets none."""
    meta = dict(device="meta")
    params = {"c1": torch.empty(8, 3, 3, 3, **meta), "c2": torch.empty(4, 8, 3, 3, **meta)}
    batch = {"image": torch.empty(2, 3, 16, 16, **meta)}

    def loss_fn(p, b):
        x = torch.relu(F.conv2d(b["image"], p["c1"], padding=1))
        return torch.relu(F.conv2d(x, p["c2"], padding=1)).mean()

    g = torch_export.trace_training_graph(loss_fn, params, batch, "convnet")
    fwd = sorted((n for n in g.nodes.values() if n.op_type == "convolution"),
                 key=lambda n: n.op_id)
    assert [n.flops for n in fwd] == [2.0 * 2 * 8 * 16 * 16 * 27, 2.0 * 2 * 4 * 16 * 16 * 72]
    prods = {p.name: prod for p, _, prod in _leaves(g)}
    for name, layer in zip(("param_0", "param_1"), fwd):
        prod = prods[name]
        assert prod.op_type == "convolution_backward"
        assert prod.split == Split.SUM and not prod.batch_dim
        assert prod.flops == layer.flops
    dx = [n for n in g.nodes.values()
          if n.op_type == "convolution_backward" and n.split == Split.CONCAT]
    assert len(dx) == 1 and dx[0].batch_dim and dx[0].flops == fwd[1].flops


# -------------------------------------------------------------------- CLI

MODEL = ["--model", "bert_small", "--batch", "8", "--n-groups", "10"]


def _run(pkg: str, argv: list, capsys) -> tuple:
    main = tcli.main if pkg == "port" else rcli.main
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both(argv_of, capsys, tmp_path, *, port_extra=()):
    out = {}
    for pkg in ("repro", "port"):
        argv = argv_of(str(tmp_path / pkg))
        rc, text = _run(pkg, argv + (list(port_extra) if pkg == "port" else []), capsys)
        assert rc == 0, text
        out[pkg] = json.loads(text)
    return out["repro"], out["port"]


def test_cli_help_lists_repro_commands_and_arguments(capsys):
    """Every command of ``repro``'s CLI, with its arguments; the port's
    commands that may build a GNN policy also take ``--device``."""
    def commands(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return capsys.readouterr().out.split("{", 1)[1].split("}", 1)[0]

    assert commands(tcli.main) == commands(rcli.main)
    for cmd in (["plan"], ["inspect"], ["evict"], ["observe"], ["calibrate"], ["drift"],
                ["trace"], ["verify"], ["metrics"], ["serve-metrics"], ["health"],
                ["policy", "train"], ["policy", "list"], ["policy", "use"],
                ["policy", "evict"]):
        flags = {}
        for pkg, main in (("repro", rcli.main), ("port", tcli.main)):
            with pytest.raises(SystemExit):
                main([*cmd, "--help"])
            text = capsys.readouterr().out
            flags[pkg] = {w.strip("[],") for w in text.split() if w.startswith(("--", "[--"))}
        assert flags["port"] - flags["repro"] <= {"--device"}, cmd
        assert flags["repro"] <= flags["port"], cmd


def test_cli_plan_cold_then_hit_as_repro(tmp_path, capsys):
    argv = lambda d: ["plan", *MODEL, "--topo", "2x1080ti", "--iterations", "4",  # noqa: E731
                      "--cache-dir", d]
    r, t = _both(argv, capsys, tmp_path)
    assert keys_of(t) == keys_of(r) and t["source"] == r["source"] == "cold"
    assert t["iterations_run"] == 4 and t["speedup"] > 0
    r, t = _both(argv, capsys, tmp_path)
    assert t["source"] == r["source"] == "hit" and t["iterations_run"] == 0


def test_cli_drift_and_observe_as_repro(tmp_path, capsys):
    plan = lambda d: ["plan", *MODEL, "--topo", "2x1080ti", "--iterations", "4",  # noqa: E731
                      "--cache-dir", d]
    _both(plan, capsys, tmp_path)
    r, t = _both(lambda d: ["drift", *MODEL, "--topo", "2x1080ti", "--observed-time", "12.0",
                            "--cache-dir", d], capsys, tmp_path)
    assert keys_of(t) == keys_of(r) and t["drifted"] and r["drifted"]
    r, t = _both(lambda d: ["observe", *MODEL, "--topo", "2x1080ti", "--observed-time", "12.0",
                            "--cache-dir", d, "--telemetry-dir", d + "/telem",
                            "--iterations", "4"], capsys, tmp_path)
    assert keys_of(t) == keys_of(r) and t["kind"] == r["kind"] == "replanned"


def test_cli_verify_as_repro(tmp_path, capsys):
    r, t = _both(lambda d: ["verify", *MODEL, "--topo", "2x1080ti",
                            "--iterations", "4", "--cache-dir", d, "--json"],
                 capsys, tmp_path)
    # which diagnostics a plan draws depends on the plan, not the package
    assert keys_of(dict(t, diagnostics=None)) == keys_of(dict(r, diagnostics=None))
    assert t["diagnostics"].keys() == r["diagnostics"].keys()
    assert t["verdict"] in ("clean", "warn") and t["summary"]["errors"] == 0
    r, t = _both(lambda d: ["verify", "--selftest"], capsys, tmp_path)
    assert keys_of(t) == keys_of(r) and t["ok"] and r["ok"]


def test_cli_trace_as_repro(tmp_path, capsys):
    """``trace``: predicted against replayed for all four schedules, each
    trace and diff file written; at zero noise the replay is the
    prediction."""
    r, t = _both(lambda d: ["trace", *MODEL, "--topo", "testbed", "--out-dir", d],
                 capsys, tmp_path)
    assert keys_of(t) == keys_of(r)
    assert sorted(t["schedules"]) == sorted(r["schedules"]) == sorted(tcli.SCHEDULES)
    for s in t["schedules"].values():
        assert s["step_error_frac"] == pytest.approx(0.0, abs=1e-12)
        with open(s["trace"]) as f:
            doc = json.load(f)
        assert any(e["ph"] == "X" for e in doc["traceEvents"])


def test_cli_policy_train_as_repro(tmp_path, capsys):
    """``policy train`` on a corpus of two zoo graphs registers a policy;
    the port's takes ``--device`` and, without it, needs a card."""
    argv = lambda d: ["policy", "train", "--models", "bert_small", "vgg19", "--name", "c",  # noqa: E731
                      "--steps", "2", "--mcts-iters", "2", "--n-groups", "10",
                      "--cache-dir", d]
    r, t = _both(argv, capsys, tmp_path, port_extra=["--device", "cpu"])
    assert keys_of(t) == keys_of(r) and t["registered"] == "c" and t["policies"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv(str(tmp_path / "card")))
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["policy", "list", "--cache-dir", str(tmp_path / "port")]) == 0
