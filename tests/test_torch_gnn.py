"""The port's GNN policy and policy registry against ``repro``'s.

``repro_torch.core.hetgnn`` and ``core.trainer`` are PyTorch ports of the JAX
GNN; ``repro_torch.service.registry`` is a copy of ``repro``'s that stores
the same npz layout. The same featurized graphs, visit records and
parameters (drawn by ``repro`` and carried over by ``params_from_numpy``) go
through both: priors, gradients and one train step agree at 1e-5, and a
checkpoint saved by either registry loads in the other with the same priors
and the same selection. ``repro``'s registry tests (``tests/test_registry.py``)
run on both packages.
"""
import copy
import functools
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("hypothesis")
import jax
import torch

from repro.core import features as r_features, hetgnn as r_hetgnn, mcts as r_mcts
from repro.core import strategy as r_strategy, tag as r_tag, trainer as r_trainer
from repro.core import device as r_device
from repro.core.device import testbed as r_testbed
from repro.service import cli as r_cli, fingerprint as r_fp, registry as r_registry
from repro.service import planner as r_planner, store as r_store, warmstart as r_warm
from repro_torch.core import features as t_features, hetgnn as t_hetgnn, mcts as t_mcts
from repro_torch.core import strategy as t_strategy, tag as t_tag, trainer as t_trainer
from repro_torch.core import device as t_device
from repro_torch.core.device import testbed as t_testbed
from repro_torch.service import cli as t_cli, fingerprint as t_fp, registry as t_registry
from repro_torch.service import planner as t_planner, store as t_store, warmstart as t_warm

from test_torch_runtime import bert_grouped

CPU = torch.device("cpu")
TOL = 1e-5
F32_TOL = 2e-5      # twice the worst f32 rounding error either package showed


def _ns(core_dev, features, hetgnn, mcts, strategy, tag, trainer, fp, registry, planner,
        store, warm, cli, testbed, cpu):
    """One package's modules, with its constructors bound to the CPU where
    the port's would otherwise ask for the card."""
    kw = {"device": "cpu"} if cpu else {}
    return SimpleNamespace(
        features=features, hetgnn=hetgnn, MCTS=mcts.MCTS, S=strategy, tag=tag,
        init_trainer=functools.partial(trainer.init_trainer, **kw),
        make_policy=functools.partial(trainer.make_policy, **kw),
        train_step=trainer.train_step, fp=fp,
        Registry=functools.partial(registry.PolicyRegistry, **kw),
        Service=functools.partial(planner.PlannerService, **kw),
        PlanStore=store.PlanStore, PlanRecord=store.PlanRecord, warm=warm, cli=cli,
        testbed=testbed, device=core_dev)


PKGS = {
    "repro": _ns(r_device, r_features, r_hetgnn, r_mcts, r_strategy, r_tag, r_trainer, r_fp,
                 r_registry, r_planner, r_store, r_warm, r_cli, r_testbed, False),
    "port": _ns(t_device, t_features, t_hetgnn, t_mcts, t_strategy, t_tag, t_trainer, t_fp,
                t_registry, t_planner, t_store, t_warm, t_cli, t_testbed, True),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def _gg(pkg, n_groups):
    return bert_grouped(n_groups)[pkg == "port"]


def _act(a):
    return t_strategy.Action(tuple(a.placement), t_strategy.Option(int(a.option)), a.schedule)


def _het(h):
    return t_features.HetGraph(*(getattr(h, f) for f in (
        "op_x", "dev_x", "oo_mask", "oo_e", "dd_mask", "dd_e", "od_e")))


def _perturbed(topo, scale=0.9):
    t2 = copy.deepcopy(topo)
    t2.inter_bw = topo.inter_bw * scale
    return t2


def _vec(fp, scalars=1.0, bucket=None, weight=0.9):
    v = [scalars] * fp.STRUCT_SCALARS + [0.0] * (fp.STRUCT_F - fp.STRUCT_SCALARS)
    if bucket is not None:
        v[fp.STRUCT_SCALARS + bucket] = weight
    return v


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(b))) if b.size else 1.0), err


@functools.lru_cache(maxsize=None)
def _trained_repro():
    """``repro``'s GNN after one train step on bert_small's visit records:
    (state, records)."""
    gg, topo = _gg("repro", 12), r_testbed()
    state = r_trainer.init_trainer(seed=0)
    sr = r_mcts.MCTS(gg, topo, seed=0, record_threshold=4).search(8)
    assert sr.visit_records
    r_trainer.train_step(state, sr.visit_records)
    return state, sr.visit_records


def _hets():
    """Featurized graphs of bert_small on the testbed: the empty strategy
    without feedback, a half-decided one with simulated feedback and a next
    group, and a full DP strategy."""
    gg, topo = _gg("repro", 12), r_testbed()
    S = r_strategy
    empty = S.Strategy.empty(gg.n)
    half = S.Strategy([S.data_parallel_all(topo) if i % 2 == 0 else None for i in range(gg.n)])
    full = S.Strategy([S.data_parallel_all(topo)] * gg.n)
    res = r_tag.evaluate_strategy(gg, full, topo)[0]
    return [(r_features.featurize(gg, topo, empty, None, 0), 0),
            (r_features.featurize(gg, topo, half, res, 3), 3),
            (r_features.featurize(gg, topo, full, res, None), gg.n - 1)]


# ------------------------------------------------------ cross-package parity

@pytest.mark.parametrize("cfg", [r_hetgnn.GNNConfig(), r_hetgnn.GNNConfig(16, 2, 2, 8)])
def test_init_gnn_keys_and_shapes(cfg):
    rp = r_hetgnn.init_gnn(cfg, jax.random.PRNGKey(0))
    tcfg = t_hetgnn.GNNConfig(cfg.hidden, cfg.heads, cfg.layers, cfg.decoder_hidden)
    tp = t_hetgnn.init_gnn(tcfg, torch.Generator().manual_seed(0), CPU)
    assert list(tp) == list(rp)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: tuple(v.shape) for k, v in rp.items()}
    assert all(v.dtype == torch.float32 and v.device == CPU for v in tp.values())
    for k, v in tp.items():                      # the same law of draw
        if k.startswith(("b_", "dec1b")):
            assert not v.any()
        elif v.numel() >= 64:
            want = 0.1 if k.startswith("a_") else (2.0 / sum(v.shape)) ** 0.5
            assert 0.7 * want < float(v.std()) < 1.3 * want, k


def test_policy_logits_and_probs_match_repro():
    state, _ = _trained_repro()
    tp = t_hetgnn.params_from_numpy(state.params, CPU)
    topo = r_testbed()
    for het, gid in _hets():
        for has_grad in (True, False):
            actions = r_strategy.candidate_actions(topo, has_grad=has_grad)
            tacts = [_act(a) for a in actions]
            rl = r_hetgnn.policy_logits(state.cfg, state.params, het, gid, actions)
            tl = t_hetgnn.policy_logits(state.cfg, tp, _het(het), gid, tacts)
            _close(tl, rl)
            rpr = r_hetgnn.policy_probs(state.cfg, state.params, het, gid, actions)
            tpr = t_hetgnn.policy_probs(state.cfg, tp, _het(het), gid, tacts)
            _close(tpr, rpr)
            # the encoder/decoder split gives the same logits
            re_op, re_dev = r_hetgnn.embed_hetgraph(state.cfg, state.params, het)
            te_op, te_dev = t_hetgnn.embed_hetgraph(state.cfg, tp, _het(het))
            _close(te_op, re_op)
            _close(te_dev, re_dev)
            m = het.dev_x.shape[0]
            _close(t_hetgnn.score_embedded(state.cfg, tp, te_op, te_dev, gid, tacts, m),
                   r_hetgnn.score_embedded(state.cfg, state.params, re_op, re_dev, gid,
                                           actions, m))


def test_policies_match_repro_cached_and_exact():
    state, _ = _trained_repro()
    topo = r_testbed()
    actions = r_strategy.candidate_actions(topo, has_grad=True)
    tacts = [_act(a) for a in actions]
    for cache in (True, False):
        rpol = r_trainer.make_policy(state.cfg, state.params, cache_embeddings=cache)
        tpol = t_trainer.make_policy(state.cfg, state.params, cache_embeddings=cache,
                                     device="cpu")
        assert getattr(tpol, "cache_embeddings", False) == cache
        for het, gid in _hets():
            got = tpol(_het(het), gid, tacts)
            assert isinstance(got, np.ndarray)
            _close(got, rpol(het, gid, actions))
        if cache:
            assert (tpol.hits, tpol.misses) == (rpol.hits, rpol.misses) == (0, 3)


def test_masked_logits_are_minus_1e30():
    state, _ = _trained_repro()
    tp = t_hetgnn.params_from_numpy(state.params, CPU)
    het, gid = _hets()[0]
    actions = [_act(a) for a in r_strategy.candidate_actions(r_testbed(), has_grad=True)]
    P, opt, mask = t_hetgnn.actions_to_arrays(actions, het.dev_x.shape[0])
    assert P.shape[0] % 8 == 0 and mask.sum() == len(actions) < P.shape[0]
    e_op, e_dev = t_hetgnn.embed_hetgraph(state.cfg, tp, _het(het))
    logits = t_hetgnn._masked(t_hetgnn.score_actions(
        state.cfg, tp, e_op, e_dev, gid, torch.from_numpy(P), torch.from_numpy(opt)),
        torch.from_numpy(mask))
    assert (logits[len(actions):] == -1e30).all()
    assert torch.isfinite(logits[:len(actions)]).all()


def _loss_inputs(rec):
    het, gid, actions, pi = rec
    P, O, mask = r_hetgnn.actions_to_arrays(actions, het.dev_x.shape[0])
    pi_pad = np.zeros((P.shape[0],), np.float32)
    pi_pad[:len(pi)] = pi
    return het, gid, P, O, mask, pi_pad


def _jax_grad(cfg, params, rec):
    het, gid, P, O, mask, pi = _loss_inputs(rec)
    return r_trainer._loss_and_grad(cfg, params, r_hetgnn._het_arrays(het), jax.numpy.asarray(gid),
                                    P, O, mask, pi)


def _torch_grad(cfg, params, rec):
    het, gid, P, O, mask, pi = _loss_inputs(rec)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = t_hetgnn.record_loss_core(cfg, leaves, r_hetgnn._het_arrays(het), gid, P, O, mask, pi)
    return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values())), strict=True))


def _err(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def test_record_loss_gradient_matches_jax_grad():
    """In f64 on both sides (JAX under ``enable_x64``) the loss and every
    gradient leaf agree at 1e-5. In f32, the precision both run in, each
    side's rounding error against the f64 gradient reaches 1e-5 of a leaf's
    scale on such records (JAX's eager ops 1.07e-5, the port 8.2e-6), each in
    its own direction; there the port is held to ``F32_TOL`` of the f64
    gradient."""
    state, records = _trained_repro()
    p32 = {k: np.asarray(v) for k, v in state.params.items()}
    p64 = {k: v.astype(np.float64) for k, v in p32.items()}
    for rec in records[:4]:
        with jax.enable_x64(True):
            rl64, rg64 = _jax_grad(state.cfg, {k: jax.numpy.asarray(v) for k, v in p64.items()},
                                   rec)
            assert rg64["dec2"].dtype == np.float64
        tl64, tg64 = _torch_grad(state.cfg, {k: torch.from_numpy(v) for k, v in p64.items()}, rec)
        assert tg64["dec2"].dtype == torch.float64
        assert _err(tl64, rl64) <= TOL
        for k in p64:
            assert _err(tg64[k], rg64[k]) <= TOL, k
        tl32, tg32 = _torch_grad(state.cfg, t_hetgnn.params_from_numpy(p32, CPU), rec)
        assert _err(tl32, rl64) <= F32_TOL
        for k in p64:
            assert _err(tg32[k], rg64[k]) <= F32_TOL, k


def test_train_step_matches_repro():
    """One train step on the same visit records from the same parameters
    and moments (the state after ``repro``'s first step), the parameters in
    f64 on both sides (JAX under ``enable_x64``; AdamW computes in f32 in
    both packages, as it does in f32 training): loss, parameters and
    moments at 1e-5. In f32 AdamW's first steps turn gradients that are
    rounding noise (about 1e-5, see above) into updates of +-lr."""
    base, records = _trained_repro()
    p64 = {k: np.asarray(v, np.float64) for k, v in base.params.items()}
    with jax.enable_x64(True):
        rstate = r_trainer.TrainState(base.cfg, {k: jax.numpy.asarray(v) for k, v in p64.items()},
                                      base.opt, dict(base.opt_state), step=base.step)
        rl = r_trainer.train_step(rstate, records)
        assert rstate.params["dec2"].dtype == np.float64
    tstate = t_trainer.TrainState(
        t_hetgnn.GNNConfig(), {k: torch.from_numpy(v) for k, v in p64.items()},
        t_trainer.AdamW(lr=3e-4, weight_decay=0.0),
        {m: t_hetgnn.params_from_numpy(base.opt_state[m], CPU) for m in ("mu", "nu")},
        step=base.step)
    trecs = [(_het(h), g, [_act(a) for a in acts], pi) for h, g, acts, pi in records]
    old = dict(tstate.params)
    tl = t_trainer.train_step(tstate, trecs)
    assert abs(tl - rl) <= TOL * max(1.0, abs(rl))
    assert tstate.step == rstate.step and tstate.losses == [tl]
    for k in rstate.params:
        assert _err(tstate.params[k], rstate.params[k]) <= TOL, k
        assert _err(tstate.opt_state["mu"][k], rstate.opt_state["mu"][k]) <= TOL, k
        assert _err(tstate.opt_state["nu"][k], rstate.opt_state["nu"][k]) <= TOL, k
    # the step makes new parameter tensors: a policy built before it keeps the old ones
    assert all(old[k] is not tstate.params[k] for k in old)
    assert any(not torch.equal(old[k], tstate.params[k]) for k in old)


def test_train_step_in_f32_runs_and_moves():
    state = t_trainer.init_trainer(seed=0, device="cpu")
    _, records = _trained_repro()
    trecs = [(_het(h), g, [_act(a) for a in acts], pi) for h, g, acts, pi in records]
    before = {k: v.clone() for k, v in state.params.items()}
    loss = t_trainer.train_step(state, trecs)
    assert np.isfinite(loss) and state.step == 1
    assert all(v.dtype == torch.float32 for v in state.params.values())
    assert any(not torch.equal(before[k], state.params[k]) for k in before)
    assert t_trainer.train_step(state, []) == 0.0 and state.step == 1


def test_repro_checkpoint_loads_in_port_with_same_priors(tmp_path):
    state, _ = _trained_repro()
    gg = _gg("repro", 12)
    r_registry.PolicyRegistry(str(tmp_path)).save(
        "rt", state.cfg, state.params, corpus=[r_fp.fingerprint_grouped_cached(gg)],
        corpus_features=[r_fp.structural_features(gg)], meta={"models": ["bert_small"]})
    treg = t_registry.PolicyRegistry(str(tmp_path), device="cpu")
    rec, params = treg.load("rt")
    assert rec.gnn_config() == t_hetgnn.GNNConfig()
    assert rec.meta["models"] == ["bert_small"]
    assert all(np.array_equal(params[k], np.asarray(state.params[k])) for k in state.params)
    name, tpol = treg.resolve(graph_fp=t_fp.fingerprint_grouped_cached(_gg("port", 12)))
    rname, rpol = r_registry.PolicyRegistry(str(tmp_path)).resolve(
        graph_fp=r_fp.fingerprint_grouped_cached(gg))
    assert name == rname == "rt"
    assert all(v.device == CPU for v in tpol.params.values())
    actions = r_strategy.candidate_actions(r_testbed(), has_grad=True)
    for het, gid in _hets():
        _close(tpol(_het(het), gid, [_act(a) for a in actions]), rpol(het, gid, actions))


def test_port_checkpoint_loads_in_repro(tmp_path):
    tstate = t_trainer.init_trainer(seed=3, device="cpu")
    t_registry.PolicyRegistry(str(tmp_path), device="cpu").save(
        "tp", tstate.cfg, tstate.params, corpus=["fpX"], meta={"steps": 0})
    rrec, rparams = r_registry.PolicyRegistry(str(tmp_path)).load("tp")
    assert rrec.gnn_config() == r_hetgnn.GNNConfig() and rrec.corpus == ["fpX"]
    assert all(np.array_equal(rparams[k], tstate.params[k].numpy()) for k in tstate.params)
    _, rpol = r_registry.PolicyRegistry(str(tmp_path)).resolve()
    actions = r_strategy.candidate_actions(r_testbed(), has_grad=True)
    het, gid = _hets()[1]
    tpol = t_trainer.make_policy(tstate.cfg, tstate.params, device="cpu")
    _close(tpol(_het(het), gid, [_act(a) for a in actions]), rpol(het, gid, actions))


def test_registry_selection_same_as_repro(tmp_path):
    """Pinned first, then the exact corpus, then the nearest by structure,
    then the newest: both registries pick the same name over one directory."""
    cfg, dummy = r_hetgnn.GNNConfig(), {"w": np.zeros(2, np.float32)}
    reg = r_registry.PolicyRegistry(str(tmp_path))
    for i, name in enumerate(("pa", "pb", "pc")):
        reg.save(name, cfg, dummy, corpus=[f"fp{name}"],
                 corpus_features=[_vec(r_fp, bucket=2 * i)], created=1.0 + i)
    treg = t_registry.PolicyRegistry(str(tmp_path), device="cpu")
    queries = [dict(), dict(graph_fp="fppa"), dict(graph_fp="zz"),
               *[dict(graph_fp="zz", graph_features=_vec(r_fp, bucket=b, weight=0.8))
                 for b in range(6)]]
    for pin in (None, "pa"):
        if pin:
            treg.set_default(pin)                 # the port pins, repro reads the pin
        got = [treg.select(**q).name for q in queries]
        assert got == [reg.select(**q).name for q in queries]
        assert len(set(got)) == (1 if pin else 3)


def test_registry_resolve_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    t_registry.PolicyRegistry(str(tmp_path), device="cpu").save(
        "p", t_hetgnn.GNNConfig(), {"w": np.ones(2, np.float32)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_registry.PolicyRegistry(str(tmp_path)).resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_trainer.make_policy(t_hetgnn.GNNConfig(), {"w": np.ones(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_trainer.init_trainer()
    # without a checkpoint nothing runs on a device: unguided on any host
    assert t_planner.PlannerService().registry is None


# ----------------------------------- repro's registry tests, on both packages

def test_structural_features_shape_and_determinism(pkg):
    ns, gg = PKGS[pkg], _gg(pkg, 12)
    f1, f2 = ns.fp.structural_features(gg), ns.fp.structural_features(gg)
    assert len(f1) == ns.fp.STRUCT_F and f1 == f2
    assert ns.fp.structural_distance(f1, f2) < 1e-9
    fa, fb = f1, ns.fp.structural_features(_gg(pkg, 10))
    assert ns.fp.structural_distance(fa, fb) < 0.05
    assert ns.fp.structural_distance(_vec(ns.fp, bucket=0), _vec(ns.fp, bucket=5)) > 0.25
    assert ns.fp.structural_distance(fa, []) == float("inf")
    assert ns.fp.structural_distance(fa, fb[:-1]) == float("inf")


def test_registry_roundtrip_identical_logits(pkg, tmp_path):
    ns, gg, topo = PKGS[pkg], _gg(pkg, 12), PKGS[pkg].testbed()
    state = ns.init_trainer(seed=0)
    sr = ns.MCTS(gg, topo, seed=0, record_threshold=4).search(8)
    assert sr.visit_records
    ns.train_step(state, sr.visit_records)
    reg = ns.Registry(str(tmp_path))
    reg.save("rt", state.cfg, state.params, corpus=[ns.fp.fingerprint_grouped_cached(gg)],
             corpus_features=[ns.fp.structural_features(gg)], meta={"models": ["bert_small"]})
    rec, params = reg.load("rt")
    assert rec.gnn_config() == state.cfg and rec.meta["models"] == ["bert_small"]
    if pkg == "port":
        params = t_hetgnn.params_from_numpy(params, CPU)
    het = ns.features.featurize(gg, topo, ns.S.Strategy.empty(gg.n), None, 0)
    actions = ns.S.candidate_actions(topo, has_grad=True)
    l1 = _np(ns.hetgnn.policy_logits(state.cfg, state.params, het, 0, actions))
    l2 = _np(ns.hetgnn.policy_logits(rec.gnn_config(), params, het, 0, actions))
    assert np.array_equal(l1, l2)


def test_registry_selection_tiers(pkg, tmp_path):
    ns = PKGS[pkg]
    reg, cfg = ns.Registry(str(tmp_path)), ns.hetgnn.GNNConfig()
    dummy = {"w": np.zeros(2, np.float32)}
    reg.save("pa", cfg, dummy, corpus=["fpA"], corpus_features=[_vec(ns.fp, bucket=0)],
             created=1.0)
    reg.save("pb", cfg, dummy, corpus=["fpB"], corpus_features=[_vec(ns.fp, bucket=5)],
             created=2.0)
    assert {r.name for r in reg.records()} == {"pa", "pb"}
    assert reg.select().name == "pb"
    assert reg.select(graph_fp="fpA").name == "pa"
    assert reg.select(graph_fp="zz", graph_features=_vec(ns.fp, bucket=0, weight=0.8)).name == "pa"
    reg.set_default("pb")
    assert reg.select(graph_fp="fpA").name == "pb" and reg.default_name() == "pb"
    assert reg.remove("pb")
    assert reg.select(graph_fp="zz").name == "pa"
    with pytest.raises(ValueError):
        reg.save("../evil", cfg, dummy)
    with pytest.raises(ValueError):
        reg.save("default", cfg, dummy)


def test_registry_resolve_reloads_after_reregistration(pkg, tmp_path):
    ns, cfg = PKGS[pkg], PKGS[pkg].hetgnn.GNNConfig()
    reg = ns.Registry(str(tmp_path))
    reg.save("p", cfg, {"w": np.ones(2, np.float32)}, created=1.0)
    _, pol1 = reg.resolve()
    _, pol1_again = reg.resolve()
    assert pol1_again is pol1
    ns.Registry(str(tmp_path)).save("p", cfg, {"w": np.zeros(2, np.float32)}, created=2.0)
    _, pol2 = reg.resolve()
    assert pol2 is not pol1
    assert float(np.asarray(pol2.params["w"]).sum()) == 0.0


def test_store_feature_entries_no_lru_promotion(pkg, tmp_path):
    ns = PKGS[pkg]
    store = ns.PlanStore(path=str(tmp_path), capacity=2)
    strat = ns.S.Strategy([ns.S.Action((0,), ns.S.Option.AR)])
    for i in range(3):
        store.put(ns.PlanRecord(
            graph_fp=f"g{i}" + "0" * 62, topo_fp=f"t{i}" + "0" * 62, topo_struct_fp="s" * 64,
            n_groups=1, topo_m=1, strategy=strat.to_dict(), sfb_plans={}, time=1.0,
            baseline_time=2.0, graph_features=_vec(ns.fp, bucket=i)))
    assert len(store._mem) == 2 and len(store) == 3
    mem_before = list(store._mem)
    assert len(store.feature_entries()) == 3
    assert list(store._mem) == mem_before and store._feat_cache
    victim = next(k for k in store._disk if k not in store._mem)
    rec = store.get(*victim)
    rec.graph_features = _vec(ns.fp, bucket=7)
    store._mem.clear()
    store.put(rec)
    store._mem.clear()
    fn = str(tmp_path / store._disk[victim])
    bumped = os.stat(fn).st_mtime + 10
    os.utime(fn, (bumped, bumped))
    assert dict((k, f) for k, f, _ in store.feature_entries())[victim] == _vec(ns.fp, bucket=7)


def test_planner_service_uses_registered_policy(pkg, tmp_path):
    ns, gg, topo = PKGS[pkg], _gg(pkg, 12), PKGS[pkg].testbed()
    state = ns.init_trainer(seed=0)
    ns.Registry(str(tmp_path / "policies")).save(
        "p0", state.cfg, state.params, corpus=[ns.fp.fingerprint_grouped_cached(gg)],
        corpus_features=[ns.fp.structural_features(gg)])
    svc = ns.Service(cache_dir=str(tmp_path))
    resp = svc.plan_graph(gg, topo, iterations=4, seed=0)
    assert resp.source == "cold" and resp.policy == "p0"
    assert svc.stats()["policy_guided"] == 1
    again = svc.plan_graph(gg, topo, iterations=4, seed=0)
    assert again.source == "hit" and again.policy is None
    assert svc.store.get(resp.graph_fp, resp.topo_fp).meta["policy"] == "p0"
    unguided = ns.Service()
    assert unguided.plan_graph(gg, topo, iterations=3, seed=0).policy is None
    assert unguided.stats()["policy_guided"] == 0


def test_find_prior_tiers(pkg):
    ns = PKGS[pkg]
    strat = ns.S.Strategy([ns.S.Action((0,), ns.S.Option.AR)])
    rec = ns.PlanRecord(
        graph_fp="g" * 64, topo_fp="t" * 64, topo_struct_fp="s" * 64, n_groups=1, topo_m=1,
        strategy=strat.to_dict(), sfb_plans={}, time=1.0, baseline_time=2.0,
        graph_features=_vec(ns.fp, bucket=0))
    store = ns.PlanStore()
    store.put(rec)
    near, far = _vec(ns.fp, bucket=0, weight=0.8), _vec(ns.fp, bucket=5)
    kind, got = ns.warm.find_prior(store, "x" * 64, "y" * 64, None, graph_features=near)
    assert kind == "warm_struct" and got.graph_fp == rec.graph_fp
    assert ns.warm.find_prior(store, "x" * 64, "y" * 64, None, graph_features=far) == ("miss", None)
    assert ns.warm.find_prior(store, "x" * 64, "t" * 64, None, graph_features=near)[0] == "warm_graph"
    assert ns.warm.find_prior(store, "x" * 64, "t" * 64, None, graph_features=far) == ("miss", None)
    legacy = copy.deepcopy(rec)
    legacy.graph_features = []
    store2 = ns.PlanStore()
    store2.put(legacy)
    assert ns.warm.find_prior(store2, "x" * 64, "y" * 64, None, graph_features=near)[0] == "miss"
    assert ns.warm.find_prior(store2, "x" * 64, "t" * 64, None, graph_features=far)[0] == "warm_graph"


def test_planner_struct_warmstart_end_to_end(pkg):
    ns, topo = PKGS[pkg], PKGS[pkg].testbed()
    svc = ns.Service()
    svc.plan_graph(_gg(pkg, 12), topo, iterations=5, seed=0)
    resp = svc.plan_graph(_gg(pkg, 10), _perturbed(topo), iterations=5, seed=0)
    assert resp.source == "warm"
    assert svc.stats()["warm"] == 1 and svc.stats()["cold"] == 1


def test_adapt_strategy_degeneracy(pkg):
    ns = PKGS[pkg]
    D, A, O, S = ns.device, ns.S.Action, ns.S.Option, ns.S.Strategy
    one = D.Topology([D.DeviceGroup(0, "V100", 1, intra_bw=1e9)], D._full_inter(1, 0))
    got = ns.warm.adapt_strategy(S([A((0, 2), O.PS), A((0,), O.AR), A((0, 1), O.AR),
                                    A((0,), O.MP), A((0,), O.PS)]), 5, one)
    assert got.actions == [None, A((0,), O.AR), None, None, None]
    two = D.Topology([D.DeviceGroup(0, "V100", 2, intra_bw=1e9)], D._full_inter(1, 0))
    assert ns.warm.adapt_strategy(S([A((0, 3), O.PS)]), 1, two).actions[0] == A((0,), O.PS)


def test_sfb_cache_content_keyed_bounded(pkg, monkeypatch):
    ns, gg, topo = PKGS[pkg], _gg(pkg, 12), PKGS[pkg].testbed()
    tag = ns.tag
    tag._SFB_CACHE.clear()
    strat = tag.dp_baseline(gg, topo)
    plans = tag.sfb_post_pass(gg, strat, topo)
    fp = ns.fp.fingerprint_grouped_cached(gg)
    assert plans and tag._SFB_CACHE and all(k[0] == fp for k in tag._SFB_CACHE)
    bogus = object()
    for key in list(tag._SFB_CACHE):
        tag._SFB_CACHE[(id(gg),) + key[1:]] = bogus
    plans2 = tag.sfb_post_pass(gg, strat, topo)
    assert all(p is not bogus for p in plans2.values()) and plans2.keys() == plans.keys()
    tag._SFB_CACHE.clear()
    monkeypatch.setattr(tag, "SFB_CACHE_MAX_ENTRIES", 2)
    tag.sfb_post_pass(gg, strat, topo)
    assert len(tag._SFB_CACHE) <= 2
    tag._SFB_CACHE.clear()


def test_cached_policy_matches_exact_policy(pkg):
    ns, gg, topo = PKGS[pkg], _gg(pkg, 12), PKGS[pkg].testbed()
    state = ns.init_trainer(seed=0)
    het = ns.features.featurize(gg, topo, ns.S.Strategy.empty(gg.n), None, 0)
    actions = ns.S.candidate_actions(topo, has_grad=True)
    cached = ns.make_policy(state.cfg, state.params)
    exact = _np(ns.hetgnn.policy_probs(state.cfg, state.params, het, 0, actions))
    assert np.allclose(np.asarray(cached(het, 0, actions)), exact, atol=1e-6)
    assert (cached.hits, cached.misses) == (0, 1)
    cached(het, 3, actions)
    assert (cached.hits, cached.misses) == (1, 1)


def test_mcts_runs_one_forward_per_episode_with_cached_policy(pkg):
    ns, gg, topo = PKGS[pkg], _gg(pkg, 12), PKGS[pkg].testbed()
    state = ns.init_trainer(seed=0)
    pol = ns.make_policy(state.cfg, state.params)
    assert pol.cache_embeddings
    sr = ns.MCTS(gg, topo, policy=pol, seed=0).search(10)
    assert pol.misses == 1 and pol.hits >= 5
    assert sr.best_reward >= 1.0 - 1e-9
    legacy = ns.make_policy(state.cfg, state.params, cache_embeddings=False)
    assert not getattr(legacy, "cache_embeddings", False)


def _mk_ckpts(ns, path, names, **budget):
    reg = ns.Registry(str(path), **budget)
    for i, n in enumerate(names):
        reg.save(n, ns.hetgnn.GNNConfig(), {"w": np.ones(4, np.float32)}, created=100.0 + i)
        t = 100.0 + i
        os.utime(os.path.join(str(path), f"{n}.json"), (t, t))
    return reg


def test_registry_budgets(pkg, tmp_path):
    ns = PKGS[pkg]
    reg = _mk_ckpts(ns, tmp_path / "count", ["a", "b", "c"], max_count=2)
    assert sorted(r.name for r in reg.records()) == ["b", "c"]
    reg = _mk_ckpts(ns, tmp_path / "age", ["old", "new"])
    assert reg.evict_expired(max_age_s=0.5, now=time.time() + 100.0) == 2 and len(reg) == 0
    reg = _mk_ckpts(ns, tmp_path / "bytes", ["a", "b", "c"])
    per = sum(os.stat(str(tmp_path / "bytes" / f"a{ext}")).st_size for ext in (".json", ".npz"))
    assert reg.evict_expired(max_bytes=2 * per + per // 2) == 1
    assert sorted(r.name for r in reg.records()) == ["b", "c"]
    reg = _mk_ckpts(ns, tmp_path / "pin", ["a", "b", "c"])
    reg.set_default("a")
    assert reg.evict_expired(max_count=1) == 2
    assert [r.name for r in reg.records()] == ["a"] and reg.default_name() == "a"
    reg = _mk_ckpts(ns, tmp_path / "orphan", ["orphan", "whole"])
    os.remove(str(tmp_path / "orphan" / "orphan.npz"))
    assert [r.name for r in reg.records()] == ["whole"]
    assert reg.evict_expired(max_count=1) == 1
    assert not os.path.exists(str(tmp_path / "orphan" / "orphan.json"))


def test_registry_cli_policy_commands(pkg, tmp_path, capsys):
    import json
    ns = PKGS[pkg]
    _mk_ckpts(ns, tmp_path / "policies", ["a", "b", "c"])
    assert ns.cli.main(["policy", "use", "--name", "b", "--cache-dir", str(tmp_path)]) == 0
    assert ns.cli.main(["policy", "list", "--cache-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert ns.cli.main(["policy", "evict", "--cache-dir", str(tmp_path), "--max-count", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"evicted": 2, "remaining": 1, "default": "b"}
    assert [r.name for r in ns.Registry(str(tmp_path / "policies")).records()] == ["b"]
