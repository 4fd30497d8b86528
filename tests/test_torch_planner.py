"""The port's copy of the TAG planner against ``repro``'s, on the same graphs.

Each graph is traced once by ``repro.core.jax_export`` (reduced qwen2-1.5b and
mamba2-130m as ``repro.launch.train --tag-search`` traces them, and two paper
zoo models), then copied node by node into ``repro_torch.core.graph``. Both
planners run the same numpy code on the same input, so every result must be
equal, not merely close.
"""
import copy
import dataclasses
import enum
import functools

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.configs import get_reduced
from repro.core import compiler as r_compiler, device as r_device, features as r_features
from repro.core import graph as r_graph, partition as r_partition, plan as r_plan
from repro.core import sfb as r_sfb, simulator as r_simulator, strategy as r_strategy
from repro.core import tag as r_tag
from repro.core.jax_export import trace_training_graph
from repro.core.zoo import build
from repro.data import SyntheticDataset
from repro.exec import schedule as r_schedule, stages as r_stages
from repro.launch.mesh import make_host_mesh
from repro.models import init_params, loss_fn
from repro_torch.core import compiler as t_compiler, device as t_device, features as t_features
from repro_torch.core import graph as t_graph, partition as t_partition, plan as t_plan
from repro_torch.core import sfb as t_sfb, simulator as t_simulator, strategy as t_strategy
from repro_torch.core import tag as t_tag
from repro_torch.exec import schedule as t_schedule, stages as t_stages

GRAPHS = ["qwen2-1.5b", "mamba2-130m", "bert_small", "vgg19"]
TOPOS = ["testbed", "cloud", "tpu_pods"]
SCHEDULES = ["gpipe", "1f1b", "interleaved", "zb"]


@functools.lru_cache(maxsize=None)
def _jax_graph(name: str):
    """The JAX-traced, unsimplified graph (never mutated: callers copy)."""
    if name in GRAPHS[:2]:
        cfg = get_reduced(name)
        params = init_params(cfg, jax.random.PRNGKey(0))
        batch = jax.tree.map(jnp.asarray, SyntheticDataset(cfg.vocab_size, 32, 4).batch(0))
        return trace_training_graph(lambda p, b: loss_fn(cfg, p, b, remat=False)[0],
                                    params, batch, name)
    return trace_training_graph(*build(name, batch=4), name)


def to_port(g):
    """A ``repro`` CompGraph copied node by node into the port's."""
    out = t_graph.CompGraph(name=g.name)
    for n in g.nodes.values():
        kw = {f.name: getattr(n, f.name) for f in dataclasses.fields(n)}
        kw["split"] = t_graph.Split(n.split.value)
        out.add_node(t_graph.OpNode(**kw))
    for e in g.edges:
        out.add_edge(e.src, e.dst, e.bytes)
    return out


def plain(x):
    """Dataclasses, enums and arrays of either package as plain values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


@functools.lru_cache(maxsize=None)
def simplified(name: str):
    rg = copy.deepcopy(_jax_graph(name))
    tg = to_port(rg)
    return rg.simplify(), tg.simplify()


@functools.lru_cache(maxsize=None)
def grouped(name: str, n_groups: int):
    rg, tg = simplified(name)
    ra, ta = r_partition.partition(rg, n_groups), t_partition.partition(tg, n_groups)
    return ra, ta, r_graph.group_graph(rg, ra), t_graph.group_graph(tg, ta)


def topos(name: str):
    return getattr(r_device, name)(), getattr(t_device, name)()


def to_port_strategy(s):
    return t_strategy.Strategy.from_dict(s.to_dict())


def _pipe_strategy(gg, placement):
    S = r_strategy
    return S.Strategy([S.Action(placement, S.Option.PIPE) if i % 2 == 0
                       else S.Action(placement, S.Option.PS) for i in range(gg.n)])


def baselines(gg, topo):
    S = r_strategy
    return {"DP-AR": S.Strategy([S.data_parallel_all(topo, S.Option.AR)] * gg.n),
            "DP-PS": S.Strategy([S.data_parallel_all(topo, S.Option.PS)] * gg.n),
            "MP": S.Strategy([S.Action((0,), S.Option.MP)] * gg.n)}


@pytest.mark.parametrize("name", GRAPHS)
def test_simplify_same(name):
    rg, tg = simplified(name)
    assert len(rg.nodes) < len(_jax_graph(name).nodes)
    assert plain(rg.nodes) == plain(tg.nodes)
    assert plain(rg.edges) == plain(tg.edges)


def to_repro(g):
    """A port CompGraph copied node by node into ``repro``'s."""
    out = r_graph.CompGraph(name=g.name)
    for n in g.nodes.values():
        kw = {f.name: getattr(n, f.name) for f in dataclasses.fields(n)}
        kw["split"] = r_graph.Split(n.split.value)
        out.add_node(r_graph.OpNode(**kw))
    for e in g.edges:
        out.add_edge(e.src, e.dst, e.bytes)
    return out


def assert_simplify_same(tg):
    """The port's linear ``simplify`` against ``repro``'s on copies of one
    graph: the same surviving nodes, and the same (src, dst, bytes) edges in
    the same order (``partition`` merges edges in list order)."""
    rg = to_repro(tg)
    tg = to_port(rg)
    rs, ts = rg.simplify(), tg.simplify()
    assert plain(rs.nodes) == plain(ts.nodes)
    assert [(e.src, e.dst, e.bytes) for e in rs.edges] == \
        [(e.src, e.dst, e.bytes) for e in ts.edges]
    assert ts.topo_order() is not None
    return rs, ts


@functools.lru_cache(maxsize=None)
def _port_trace(name: str):
    """The port's own aten trace of the reduced model (torch_export)."""
    import torch
    from repro_torch.configs import get_reduced as t_get_reduced
    from repro_torch.core.torch_export import trace_training_graph as torch_trace
    from repro_torch.data.synthetic import SyntheticDataset as TDataset
    from repro_torch.models import model as t_model
    cfg = dataclasses.replace(t_get_reduced(name), attn_impl="jnp")
    params = t_model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TDataset(cfg.vocab_size, 32, 4).device_batch(0, "cpu")
    return torch_trace(lambda p, b: t_model.loss_fn(cfg, p, b, remat=False)[0], params, batch,
                       name)


@pytest.mark.parametrize("name", GRAPHS[:2])
def test_simplify_same_on_port_traces(name):
    rs, ts = assert_simplify_same(_port_trace(name))
    assert len(ts.nodes) < len(_port_trace(name).nodes)


TRIVIAL_OPS = ("copy", "convert_element_type", "stop_gradient", "broadcast_in_dim")


def _node(i, op, **kw):
    return t_graph.OpNode(i, f"{op}{i}", op, **kw)


def test_simplify_same_on_trivial_chains_and_parallel_edges():
    """Hand-built cases: a chain of trivial nodes (each one's producer was
    itself spliced), a trivial node fed by two parallel edges (two inputs:
    kept), one with no input (kept), one feeding a parallel pair, and a
    dangling branch the anchor pass drops."""
    g = t_graph.CompGraph(name="chains")
    g.add_node(_node(0, "dot_general", flops=1.0, is_grad_producer=True))
    for i in range(1, 5):
        g.add_node(_node(i, TRIVIAL_OPS[i % 4]))        # 1-4: a trivial chain
    g.add_node(_node(5, "dot_general", flops=2.0, is_grad_producer=True))
    g.add_node(_node(6, "copy"))                        # fed twice by 5
    g.add_node(_node(7, "convert_element_type"))        # no input
    g.add_node(_node(8, "add", flops=1.0))
    g.add_node(_node(9, "broadcast_in_dim"))            # feeds 8 twice
    g.add_node(_node(10, "mul", flops=1.0))             # dangling
    g.add_node(_node(11, "apply", is_apply_grad=True))
    for src, dst, b in [(0, 1, 8), (1, 2, 8), (2, 3, 4), (3, 4, 4), (4, 5, 4), (5, 6, 2),
                        (5, 6, 3), (6, 8, 1), (7, 8, 5), (5, 9, 6), (9, 8, 7), (9, 8, 9),
                        (8, 11, 1), (10, 10, 1)]:
        g.add_edge(src, dst, b)
    rs, ts = assert_simplify_same(g)
    assert set(ts.nodes) == {0, 5, 6, 7, 8, 11}
    assert [(e.src, e.dst, e.bytes) for e in ts.edges] == [
        (5, 6, 2.0), (5, 6, 3.0), (6, 8, 1.0), (7, 8, 5.0), (8, 11, 1.0), (0, 5, 4.0),
        (5, 8, 7.0), (5, 8, 9.0)]


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_simplify_same_on_random_graphs(data):
    """Random DAGs over trivial and real ops, with parallel edges, zero-input
    trivial nodes and chains of trivial nodes."""
    n = data.draw(st.integers(min_value=2, max_value=40))
    g = t_graph.CompGraph(name="random")
    for i in range(n):
        op = data.draw(st.sampled_from(TRIVIAL_OPS + ("dot_general", "add")))
        g.add_node(_node(i, op, flops=0.0 if op in TRIVIAL_OPS else 1.0,
                         is_grad_producer=data.draw(st.booleans()) and op == "dot_general",
                         is_param=data.draw(st.integers(0, 9)) == 0))
    for _ in range(data.draw(st.integers(min_value=0, max_value=3 * n))):
        a = data.draw(st.integers(min_value=0, max_value=n - 2))
        b = data.draw(st.integers(min_value=a + 1, max_value=n - 1))
        for _ in range(data.draw(st.integers(min_value=1, max_value=2))):
            g.add_edge(a, b, float(data.draw(st.integers(1, 9))))
    assert_simplify_same(g)


def test_simplify_is_linear_on_20000_nodes():
    """20,000 nodes in 2,000 chains of real and trivial ops, 10,000 of them
    trivial: the splice-and-rebuild loop this replaced rebuilt the edge list
    once per trivial node (about 2e8 edge visits here); the linear one takes
    a fraction of a second."""
    import time
    g = t_graph.CompGraph(name="long")
    nid = 0
    for c in range(2000):
        prev = None
        for j in range(10):
            op = "dot_general" if j % 2 == 0 else TRIVIAL_OPS[(c + j) % 4]
            g.add_node(_node(nid, op, flops=1.0 if op == "dot_general" else 0.0,
                             is_grad_producer=j == 8))
            if prev is not None:
                g.add_edge(prev, nid, 4.0)
            prev = nid
            nid += 1
    assert len(g.nodes) == 20_000
    t0 = time.perf_counter()
    g.simplify()
    took = time.perf_counter() - t0
    assert len(g.nodes) == 10_000 and len(g.edges) == 2000 * 4
    assert took < 3.0, took


@pytest.mark.parametrize("n_groups", [12, 24])
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_and_grouping_same(name, n_groups):
    ra, ta, rgg, tgg = grouped(name, n_groups)
    assert ra == ta
    assert rgg.n > 1
    assert plain(rgg.groups) == plain(tgg.groups)
    assert rgg.edges == tgg.edges


@pytest.mark.parametrize("topo_name", TOPOS)
@pytest.mark.parametrize("name", GRAPHS)
def test_baselines_simulate_same(name, topo_name):
    _, _, rgg, tgg = grouped(name, 12)
    rt, tt = topos(topo_name)
    for label, strat in baselines(rgg, rt).items():
        rres = r_simulator.simulate(r_compiler.compile_strategy(rgg, strat, rt), rt)
        tres = t_simulator.simulate(
            t_compiler.compile_strategy(tgg, to_port_strategy(strat), tt), tt)
        assert rres.makespan == tres.makespan, label
        assert rres.feasible == tres.feasible, label
        assert rres.makespan > 0


@pytest.mark.parametrize("name", GRAPHS)
def test_featurize_same(name):
    _, _, rgg, tgg = grouped(name, 24)
    rt, tt = topos("testbed")
    strat = baselines(rgg, rt)["DP-PS"].with_action(1, r_strategy.Action((0, 2), r_strategy.Option.AR))
    rres = r_simulator.simulate(r_compiler.compile_strategy(rgg, strat, rt), rt)
    tres = t_simulator.simulate(t_compiler.compile_strategy(tgg, to_port_strategy(strat), tt), tt)
    rh = r_features.featurize(rgg, rt, strat, rres, next_gid=2)
    th = t_features.featurize(tgg, tt, to_port_strategy(strat), tres, next_gid=2)
    for f in dataclasses.fields(rh):
        a, b = getattr(rh, f.name), getattr(th, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


@st.composite
def sfb_problem(draw):
    """The grid of ``tests/test_sfb.py``."""
    n = draw(st.integers(2, 9))
    rng = np.random.default_rng(draw(st.integers(0, 1 << 30)))
    edges = []
    for j in range(1, n):
        for i in range(j):
            if rng.random() < 0.45:
                edges.append((i, j, float(rng.uniform(1e4, 1e8))))
    return dict(
        ops=list(range(n)), edges=edges,
        times={o: float(rng.uniform(1e-6, 1e-3)) for o in range(n)},
        g=n - 1, l=n, grad_bytes=float(rng.uniform(1e5, 1e9)),
        D=int(rng.integers(2, 9)), tau=float(rng.uniform(1e9, 1e10)))


@given(sfb_problem())
@settings(max_examples=60, deadline=None)
def test_sfb_solvers_same(kw):
    rp, tp = r_sfb.SFBProblem(**kw), t_sfb.SFBProblem(**copy.deepcopy(kw))
    assert plain(r_sfb.solve(rp)) == plain(t_sfb.solve(tp))
    assert plain(r_sfb.solve_brute(rp)) == plain(t_sfb.solve_brute(tp))


@pytest.mark.parametrize("name", GRAPHS)
def test_stage_plans_and_schedule_costs_same(name):
    _, _, rgg, tgg = grouped(name, 24)
    rt, tt = topos("testbed")
    strat = _pipe_strategy(rgg, (0, 1, 5))
    rsp = r_stages.build_stage_plan(rgg, strat, rt, n_micro=8)
    tsp = t_stages.build_stage_plan(tgg, to_port_strategy(strat), tt, n_micro=8)
    assert rsp is not None and rsp.n_stages >= 2
    assert rsp.to_dict() == tsp.to_dict()
    for sched in SCHEDULES:
        rc = r_schedule.schedule_step_cost(rsp, rt, sched, global_micro=16)
        tc = t_schedule.schedule_step_cost(tsp, tt, sched, global_micro=16)
        assert plain(rc) == plain(tc), sched


@functools.lru_cache(maxsize=None)
def optimized(name: str):
    _, _, rgg, tgg = grouped(name, 24)
    rt, tt = topos("testbed")
    return (r_tag.optimize(None, None, None, rt, gg=rgg, iterations=8, seed=0),
            t_tag.optimize(None, None, None, tt, gg=tgg, iterations=8, seed=0))


@pytest.mark.parametrize("name", GRAPHS)
def test_tag_optimize_same(name):
    rr, tr = optimized(name)
    assert rr.strategy.canonical_json() == tr.strategy.canonical_json()
    assert {g: p.to_dict() for g, p in rr.sfb_plans.items()} \
        == {g: p.to_dict() for g, p in tr.sfb_plans.items()}
    assert rr.time == tr.time and rr.baseline_time == tr.baseline_time
    assert tr.time > 0


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("name", GRAPHS)
def test_lower_strategy_same(name, pipelined):
    _, _, rgg, tgg = grouped(name, 24)
    rt, tt = topos("testbed")
    strat = _pipe_strategy(rgg, (0, 1, 5)) if pipelined else optimized(name)[0].strategy
    rplan = r_plan.lower_strategy(strat, rgg, rt, make_host_mesh(), n_micro=4)
    tplan = t_plan.lower_strategy(to_port_strategy(strat), tgg, tt, n_micro=4)
    assert tplan.rules == rplan.rules.rules
    assert tplan.summary == rplan.summary
    assert tplan.grad_sync == rplan.grad_sync and tplan.zero1 == rplan.zero1
    assert tplan.is_pipelined == rplan.is_pipelined
    assert rplan.is_pipelined or not pipelined
    if rplan.is_pipelined:
        assert tplan.stage_plan.to_dict() == rplan.stage_plan.to_dict()


def test_h100_nodes_topology():
    """The port's own topology: NVLink 4 inside each node, one NDR port
    between nodes, at the data sheet's H100 peak."""
    topo = t_device.h100_nodes()
    assert topo.m == 2 and topo.total_devices == 16
    assert all(g.gpu_type == "H100" and g.intra_bw == 450e9 for g in topo.groups)
    assert topo.nominal_bw(0, 1) == 50e9
    # NVLink and NDR are not TCP: the priors tpu_pods takes, not the TCP fits
    assert (topo.coll_eff_cross, topo.coll_eff_intra, topo.p2p_eff) == (0.8, 0.9, 0.9)
    tpu = r_device.tpu_pods()
    assert (topo.coll_eff_cross, topo.coll_eff_intra, topo.p2p_eff) == \
        (tpu.coll_eff_cross, tpu.coll_eff_intra, tpu.p2p_eff)
    assert t_device.peak_flops("H100") == 989e12
    assert topo.groups[0].flops == 989e12 * t_device.default_util("H100")
    assert set(r_device.GPU_PEAKS) < set(t_device.GPU_PEAKS)
    for k, v in r_device.GPU_PEAKS.items():
        assert t_device.GPU_PEAKS[k] == v


def test_profiler_times_matmuls_on_the_device_it_is_given():
    """``profile_matmul_batches`` on the CPU (perf_counter) fits a line;
    asking for CUDA without a card raises instead of timing the CPU."""
    import torch
    from repro_torch.core import profiler
    model = profiler.profile_matmul_batches([16, 64, 256], dim=64, device="cpu")
    assert model.a >= 0 and model.b >= 0 and model(256) > 0
    assert profiler.measure_op(torch.mm, torch.ones(8, 8), torch.ones(8, 8), device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiler.profile_matmul_batches([16], dim=64, device="cuda")
