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
