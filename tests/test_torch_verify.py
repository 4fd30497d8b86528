"""The port's copy of the static plan verifier (``repro_torch.verify``)
against ``repro.verify``.

The mutation self-test runs on the port's copy and must flag every injected
violation, as ``repro``'s does (``tests/test_verify.py``). The generated
schedule grids of ``tests/test_verify.py`` and the hypothesis properties of
``tests/test_verify_properties.py`` run through both copies, on
``StagePlan``s built in each package from the same ``to_dict`` and on the
same event lists, and must give the same diagnostics: code, severity,
message and location, in order. Both copies are numpy, so equal means
equal.
"""
import dataclasses

import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import device as r_device
from repro.exec import schedule as r_schedule
from repro.exec import stages as r_stages
from repro import verify as r_verify
from repro.verify import memory as r_memory
from repro.verify import mutate as r_mutate
from repro_torch.core import device as t_device
from repro_torch.exec import schedule as t_schedule
from repro_torch.exec import stages as t_stages
from repro_torch import verify as t_verify
from repro_torch.verify import memory as t_memory
from repro_torch.verify import mutate as t_mutate

SCHEDULES = r_schedule.SCHEDULES
MUTATION_NAMES = [m.name for m in r_mutate.MUTATIONS]


def diags(rep) -> list:
    """A report as plain values: code, severity, message, location."""
    return [(d.code, d.severity.value, d.message, d.loc.to_dict()) for d in rep.diagnostics]


def to_port_order(order) -> list:
    return [[t_schedule.Event(**dataclasses.asdict(e)) for e in evs] for evs in order]


def to_port_plan(plan):
    return t_stages.StagePlan.from_dict(plan.to_dict())


def to_port_topo(topo):
    groups = [t_device.DeviceGroup(g.group_id, g.gpu_type, g.num_gpus, intra_bw=g.intra_bw,
                                   mem_bytes=g.mem_bytes, flops=g.flops) for g in topo.groups]
    return t_device.Topology(groups, topo.inter_bw.copy(), latency=topo.latency,
                             name=topo.name, coll_eff_cross=topo.coll_eff_cross,
                             coll_eff_intra=topo.coll_eff_intra, p2p_eff=topo.p2p_eff)


def to_port_context(ctx):
    """A ``repro`` mutation context rebuilt in the port from plain values."""
    return t_mutate.MutationContext(
        plan=to_port_plan(ctx.plan), topo=to_port_topo(ctx.topo),
        order=to_port_order(ctx.order), schedule=ctx.schedule, n_micro=ctx.n_micro,
        n_chunks=ctx.n_chunks, positions=dict(ctx.positions))


def port_mutation(name):
    return next(m for m in t_mutate.MUTATIONS if m.name == name)


# ------------------------------------------------------- mutation self-test

def test_selftest_catches_every_injected_violation_as_repro_does():
    t_res = t_verify.run_selftest()
    r_res = r_verify.run_selftest()
    assert t_res["clean_baselines_ok"] is True and t_res["ok"] is True
    assert t_res["missed"] == []
    assert t_res["caught"] == t_res["mutations_run"] >= 40
    assert (t_res["caught"], t_res["mutations_run"]) == (r_res["caught"], r_res["mutations_run"])
    assert [m.name for m in t_mutate.MUTATIONS] == MUTATION_NAMES
    assert [(m.klass, m.expect) for m in t_mutate.MUTATIONS] == \
        [(m.klass, m.expect) for m in r_mutate.MUTATIONS]


@pytest.mark.parametrize("name", MUTATION_NAMES)
def test_mutation_gives_repro_diagnostics(name):
    """Each mutation, on every schedule family it applies to, applied to the
    same context in each package: the port flags its designated codes and
    reports exactly what ``repro`` reports."""
    r_mut = next(m for m in r_mutate.MUTATIONS if m.name == name)
    applied = 0
    for sched in SCHEDULES:
        r_ctx = r_mutate.make_context(sched)
        t_ctx = to_port_context(r_ctx)
        assert diags(t_mutate.verify_context(t_ctx)) == diags(r_mutate.verify_context(r_ctx))
        r_ok, t_ok = r_mut.apply(r_ctx), port_mutation(name).apply(t_ctx)
        assert r_ok == t_ok
        if not r_ok:
            continue
        applied += 1
        t_rep = t_mutate.verify_context(t_ctx)
        assert t_rep.has(*r_mut.expect) and not t_rep.ok
        assert diags(t_rep) == diags(r_mutate.verify_context(r_ctx)), (sched, name)
    assert applied > 0


@pytest.mark.parametrize("sched", SCHEDULES)
def test_clean_baseline_verifies_clean(sched):
    rep = t_mutate.verify_context(t_mutate.make_context(sched))
    assert rep.verdict == "clean", rep.format()
    assert diags(rep) == diags(r_mutate.verify_context(r_mutate.make_context(sched)))


# --------------------------------------------------- generated schedules

@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (3, 6), (4, 8), (6, 12)])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_generated_schedules_verify_clean(sched, n_stages, n_micro):
    V = 2 if sched == "interleaved" else 1
    order = r_schedule.make_schedule(sched, n_stages, n_micro, n_chunks=V)
    t_order = t_schedule.make_schedule(sched, n_stages, n_micro, n_chunks=V)
    assert t_order == to_port_order(order)
    rep = t_verify.verify_schedule(t_order, n_stages, n_micro, n_chunks=V)
    assert rep.ok and not rep.diagnostics, rep.format()
    assert diags(rep) == diags(r_verify.verify_schedule(order, n_stages, n_micro, n_chunks=V))


def _plan_dict(sync="allreduce", n_devices=2, out_bytes=1e5, n_micro=8):
    return r_stages.StagePlan(
        stages=[r_stages.StageSpec(i, 1 + i, [i], flops=1e9, param_bytes=1e5,
                                   grad_bytes=1e5, out_bytes=out_bytes, sync=sync,
                                   n_devices=n_devices, gpu_type="1080Ti") for i in range(2)],
        placement=(1, 2), n_micro=n_micro).to_dict()


@pytest.mark.parametrize("engine", ["eager", "scan"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_memory_proof_matches_repro(sched, engine):
    """The engine-aware memory prover on a plan that fits eagerly and OOMs
    under the scan engine's stash (``tests/test_verify.py``'s case)."""
    M, V = 8, 2 if sched == "interleaved" else 1
    d = _plan_dict(out_bytes=16e9, n_micro=M)
    r_plan, t_plan = r_stages.StagePlan.from_dict(d), t_stages.StagePlan.from_dict(d)
    order = r_schedule.make_schedule(sched, 2, M, n_chunks=V)
    r_rep = r_memory.analyze_memory(r_plan, r_device.testbed(), order, M, engine=engine)
    t_rep = t_memory.analyze_memory(t_plan, t_device.testbed(), to_port_order(order), M,
                                    engine=engine)
    assert diags(t_rep) == diags(r_rep)
    assert t_memory.engine_peak_stash(to_port_order(order), M, engine) == \
        r_memory.engine_peak_stash(order, M, engine)


@pytest.mark.parametrize("counts", [None, [1, 2], [2, 2], [4, 4]])
@pytest.mark.parametrize("sync", ["allreduce", "ps", "sfb", "nccl"])
def test_preflight_matches_repro(sync, counts):
    """The engine's preflight on the same plan and device-set sizes: SFB on
    one device and an unknown sync mode are errors in both."""
    d = _plan_dict(sync=sync)
    order = r_schedule.make_schedule("1f1b", 2, 8)
    r_rep = r_verify.verify_preflight(r_stages.StagePlan.from_dict(d), order, 8,
                                      device_counts=counts)
    t_rep = t_verify.verify_preflight(t_stages.StagePlan.from_dict(d), to_port_order(order), 8,
                                      device_counts=counts)
    assert diags(t_rep) == diags(r_rep)
    assert t_rep.ok == r_rep.ok


def test_corrupt_schedule_and_verification_error():
    ctx = t_mutate.make_context("1f1b")
    evs = ctx.order[2]
    del evs[next(i for i, e in enumerate(evs) if e.kind == "B")]
    rep = t_verify.verify_preflight(ctx.plan, ctx.order, ctx.n_micro, n_chunks=ctx.n_chunks)
    assert not rep.ok and rep.has("TAG104")
    err = t_verify.PlanVerificationError(rep, context="unit test")
    assert "unit test" in str(err) and "TAG104" in str(err) and err.report is rep
    assert {k: (v[0].value, v[1]) for k, v in t_verify.CODES.items()} == \
        {k: (v[0].value, v[1]) for k, v in r_verify.CODES.items()}


# ------------------------------------------------------------- properties

@st.composite
def schedule_params(draw):
    sched = draw(st.sampled_from(SCHEDULES))
    n_stages = draw(st.integers(min_value=2, max_value=6))
    if sched == "interleaved":
        n_micro = n_stages * draw(st.integers(min_value=1, max_value=4))
        n_chunks = draw(st.integers(min_value=2, max_value=3))
    else:
        n_micro = draw(st.integers(min_value=1, max_value=16))
        n_chunks = 1
    return sched, n_stages, n_micro, n_chunks


@settings(max_examples=80, deadline=None)
@given(params=schedule_params())
def test_random_valid_schedules_verify_clean_in_both(params):
    sched, S, M, V = params
    order = r_schedule.make_schedule(sched, S, M, n_chunks=V)
    rep = t_verify.verify_schedule(to_port_order(order), S, M, n_chunks=V)
    assert rep.ok and not rep.diagnostics, rep.format()
    assert diags(rep) == diags(r_verify.verify_schedule(order, S, M, n_chunks=V))


@settings(max_examples=120, deadline=None)
@given(name=st.sampled_from(MUTATION_NAMES), sched=st.sampled_from(SCHEDULES),
       n_stages=st.integers(min_value=3, max_value=6), mult=st.integers(min_value=1, max_value=3))
def test_every_mutation_class_is_flagged_as_repro_flags_it(name, sched, n_stages, mult):
    n_micro = n_stages * mult
    r_ctx = r_mutate.make_context(sched, n_stages=n_stages, n_micro=n_micro)
    t_ctx = to_port_context(r_ctx)
    r_mut = next(m for m in r_mutate.MUTATIONS if m.name == name)
    r_ok, t_ok = r_mut.apply(r_ctx), port_mutation(name).apply(t_ctx)
    assert r_ok == t_ok
    if not r_ok:
        return
    rep = t_mutate.verify_context(t_ctx)
    assert rep.has(*r_mut.expect), (name, sched, n_stages, n_micro, sorted(rep.codes()))
    assert diags(rep) == diags(r_mutate.verify_context(r_ctx))
