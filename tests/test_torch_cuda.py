"""The CUDA kernels on the card against their plain versions on the same
inputs. Needs a CUDA device and nvcc; skips without a card.

Run on the card with ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Tolerances, as tests/test_kernels.py. Flash attention: f32 2e-5 (summation
order; TF32 off for the plain version), bf16 3e-2 (one bf16 rounding of the
output). In bf16 the output may also differ from the plain version run in
f32 by at most 1e-4 beyond half a bf16 step: P V is computed in f32
precision, as on the TPU (P rounded to bf16 would exceed it by about 3e-3).
SSD scan: y f32 1e-4, bf16 1e-1; the f32 state h 1e-4 x max(1, max|h|); in
bf16 y may differ from the plain version run in f32 by at most 1e-4 beyond
half a bf16 step (the kernel computes in f32 and rounds y once).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.ref import ref_gqa_attention, ref_ssd_chunked

CASES = {
    # name: (B, S, H, KV, hd, causal, window)
    "serve_slice": (4, 512, 12, 2, 128, True, 0),
    "mha_hd64": (2, 256, 2, 2, 64, True, 0),
    "window_100": (1, 256, 2, 2, 32, True, 100),
    "noncausal": (1, 128, 1, 1, 64, False, 0),
    "ragged_causal": (2, 100, 4, 2, 80, True, 0),
    "ragged_window": (1, 200, 4, 1, 16, True, 48),
    "ragged_noncausal": (1, 70, 2, 2, 128, False, 0),
    # edges of the bf16 kernel: G that its two query heads a block do not
    # divide, a sequence under one tile, hd 16 and 128 with a window
    "heads_G5": (1, 192, 5, 1, 64, True, 0),
    "heads_G3_S130": (2, 130, 6, 2, 48, True, 0),
    "short_S40": (2, 40, 4, 2, 64, True, 0),
    "window_hd16": (1, 256, 4, 2, 16, True, 48),
    "window_hd128": (1, 320, 6, 2, 128, True, 100),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(case, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, hd, causal, window = CASES[case]
    rng = np.random.default_rng(0)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dt)

    q, k, v = rand(B, S, H, hd), rand(B, S, KV, hd), rand(B, S, KV, hd)
    before = fa_mod.flash_attention.launches
    o = fa_mod.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_mod.flash_attention.launches == before + 1
    ref = ref_gqa_attention(q, k, v, causal=causal, window=window)
    assert o.dtype == dt and o.shape == q.shape
    err = (o.float() - ref.float()).abs().max().item()
    assert err <= atol, (case, dtype, err)
    if dt == torch.bfloat16:                  # against the plain version in f32
        ref = ref_gqa_attention(q.float(), k.float(), v.float(), causal=causal, window=window)
        assert _rounding_excess(o, ref) <= 1e-4, (case, _rounding_excess(o, ref))


def _rounding_excess(o, ref) -> float:
    """Largest |o - ref| beyond half a bf16 step of ref."""
    _, e = torch.frexp(ref)
    half_ulp = torch.where(ref == 0, 0.0, torch.exp2((e - 9).float()))
    return ((o.float() - ref).abs() - half_ulp).max().item()


SSD_CASES = {
    # name: (Bb, S, nh, hd, g, ds, chunk)
    "serve_slice": (4, 1024, 24, 64, 1, 128, 128),
    "sweep_S128": (2, 128, 2, 32, 2, 16, 64),
    "sweep_S256": (2, 256, 4, 64, 4, 32, 128),
    "sweep_S192": (2, 192, 1, 16, 1, 8, 64),
    "groups": (2, 256, 8, 32, 2, 64, 128),
    "padded": (1, 150, 3, 24, 1, 20, 50),
    # edges of the bf16 kernel's hd slices of 32 columns, and the serve
    # slice's heads and single group at a shorter sequence
    "hdslice24": (2, 256, 4, 24, 2, 64, 128),
    "hdslice48": (2, 256, 4, 48, 2, 64, 128),
    "nh24_g1": (2, 512, 24, 64, 1, 128, 128),
}


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 1e-1)])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(case, dtype, atol, strided):
    """``strided``: x, B and C are views of one (Bb, S, conv_ch) tensor, as
    the model hands them over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    Bb, S, nh, hd, g, ds, chunk = SSD_CASES[case]
    rng = np.random.default_rng(1)
    dt_ = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dt_)

    # B and C at std min(1, (16/ds)^(1/4)): C Bᵀ spreads as at ds 16 and |y|
    # stays under 16, where 1e-1 exceeds one bf16 step of y. At unit std and
    # ds 128 the plain bf16 route, which rounds C Bᵀ to bf16 as JAX does,
    # moves y by a whole step (0.125) beside the kernel's f32 C Bᵀ.
    bc_std = min(1.0, (16 / ds) ** 0.25)
    if strided:
        xbc = rand(Bb, S, nh * hd + 2 * g * ds).float()
        xbc[..., nh * hd:] *= bc_std
        x, B, C = torch.split(xbc.to(dt_), [nh * hd, g * ds, g * ds], dim=-1)
        x, B, C = x.reshape(Bb, S, nh, hd), B.reshape(Bb, S, g, ds), C.reshape(Bb, S, g, ds)
    else:
        x = rand(Bb, S, nh, hd)
        B, C = ((rand(Bb, S, g, ds).float() * bc_std).to(dt_) for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bb, S, nh)).astype(np.float32)).cuda()
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, nh).astype(np.float32)).cuda()
    before = ssd_mod.ssd_scan.launches
    y, h = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_mod.ssd_scan.launches == before + 1
    rep = nh // g
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    yr, hr = ref_ssd_chunked(x, dt, A, Bh, Ch, chunk)
    assert y.dtype == dt_ and y.shape == x.shape and h.shape == hr.shape
    err = (y.float() - yr.float()).abs().max().item()
    assert err <= atol, (case, dtype, err)
    h_err = (h - hr).abs().max().item()
    assert h_err <= 1e-4 * max(1.0, hr.abs().max().item()), (case, dtype, h_err)
    if dt_ == torch.bfloat16:                 # against the plain version in f32
        yr32, _ = ref_ssd_chunked(x.float(), dt, A, Bh.float(), Ch.float(), chunk)
        assert _rounding_excess(y, yr32) <= 1e-4, (case, _rounding_excess(y, yr32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_model_dt(dtype):
    """dt and A as the full-width model draws them (dt = softplus(N(0,
    0.55^2)), A = -1), so that cum falls to about -96 within a chunk of 128,
    past f32's exp underflow; x, B and C at unit std, strided as the model
    hands them over. |y| reaches about 1e2, so the y tolerances (1e-4 in
    f32, 1e-1 in bf16, and in bf16 1e-4 beyond half a bf16 step of the f32
    plain version) are relative to max(1, max |y|), as in chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    Bb, S, nh, hd, g, ds, chunk = 2, 512, 24, 64, 1, 128, 128
    rng = np.random.default_rng(3)
    dt_ = getattr(torch, dtype)
    xbc = torch.from_numpy(rng.standard_normal((Bb, S, nh * hd + 2 * g * ds)).astype(np.float32))
    x, B, C = torch.split(xbc.to("cuda", dt_), [nh * hd, g * ds, g * ds], dim=-1)
    x, B, C = x.reshape(Bb, S, nh, hd), B.reshape(Bb, S, g, ds), C.reshape(Bb, S, g, ds)
    dt = torch.from_numpy(np.log1p(np.exp(0.55 * rng.standard_normal((Bb, S, nh))))
                          .astype(np.float32)).cuda()
    A = -torch.ones(nh, device="cuda")
    y, h = ssd_mod.ssd_scan(x, dt, A, B, C, chunk=chunk)
    Bh, Ch = B.repeat_interleave(nh // g, dim=2), C.repeat_interleave(nh // g, dim=2)
    yr, hr = ref_ssd_chunked(x, dt, A, Bh, Ch, chunk)
    scale = max(1.0, yr.float().abs().max().item())
    assert bool(torch.isfinite(y.float()).all())
    err = (y.float() - yr.float()).abs().max().item()
    assert err <= {"float32": 1e-4, "bfloat16": 1e-1}[dtype] * scale, (dtype, err, scale)
    h_err = (h - hr).abs().max().item()
    assert h_err <= 1e-4 * max(1.0, hr.abs().max().item()), (dtype, h_err)
    if dt_ == torch.bfloat16:
        yr32, _ = ref_ssd_chunked(x.float(), dt, A, Bh.float(), Ch.float(), chunk)
        assert _rounding_excess(y, yr32) <= 1e-4 * scale, (_rounding_excess(y, yr32), scale)


@pytest.mark.gpu
def test_launch_plans_at_the_serve_shapes():
    """The bf16 flash kernel serves two query heads of one KV head a block
    (K and V loaded once for both); the bf16 SSD kernel fills the card with
    more than one block per (head, batch) by slicing hd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = fa_mod.launch_plan(4, 512, 12, 2, 128, torch.bfloat16)
    assert plan["heads_per_block"] == 2 and plan["blocks"] == 8 * 4 * 2 * 3
    plan = ssd_mod.launch_plan(4, 24, 64, 128, 128, torch.bfloat16)
    assert plan["blocks"] == 2 * 24 * 4 > 96 and plan["smem_bytes"] <= 227 * 1024 // 2


@pytest.mark.gpu
def test_kernel_routes_refuse_autograd_on_cuda():
    """On CUDA tensors that record gradients both wrappers raise, before any
    launch, where they once returned outputs with no gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.randn(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    before = fa_mod.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa_mod.flash_attention(q, q.detach(), q.detach())
    x = torch.randn(1, 128, 2, 32, device="cuda", requires_grad=True)
    dt = torch.full((1, 128, 2), 0.1, device="cuda")
    A = -torch.ones(2, device="cuda")
    B = torch.randn(1, 128, 1, 16, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_mod.ssd_scan(x, dt, A, B, B, chunk=64)
    assert fa_mod.flash_attention.launches == before
    with torch.no_grad():
        fa_mod.flash_attention(q, q, q)
    assert fa_mod.flash_attention.launches == before + 1


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_train_step_on_card_matches_cpu(arch):
    """One f32 train step of the reduced model on the card against the same
    step on the CPU, from the same parameters and batch, TF32 off (the check
    of chip_smoke.py's train phase, at reduced size): loss 1e-4 relative,
    each gradient leaf 1e-3 x max(1, max |g|); the parameters that clipping
    and AdamW make of the same gradients (the card's) 1e-5 x max(1, max |p|).
    On each side's own gradients AdamW's first step, lr x g / (|g| + eps),
    would turn round-off of a gradient near eps into a difference of up to
    lr."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.steps import StepOptions, make_train_step
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import AdamW, clip_by_global_norm, from_leaves, leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ds = SyntheticDataset(cfg.vocab_size, 64, 2, seed=1)
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt, None, StepOptions(loss_chunk=32))
    out = {}
    for dev in ("cuda", "cpu"):
        p = _tree_map(lambda t: t.detach().to(dev).clone(), params)
        batch = ds.device_batch(0, dev)
        ps = leaves(p)
        for t in ps:
            t.requires_grad_(True)
        loss, _ = loss_fn(cfg, p, batch, loss_chunk=32)
        grads = [g.cpu() for g in torch.autograd.grad(loss, ps)]
        _, _, m = step(p, opt.init(p), 0, batch)
        out[dev] = (float(m["loss"]), grads)
    (lc, gc), (lr, gr) = out["cuda"], out["cpu"]
    assert abs(lc - lr) <= 1e-4 * abs(lr)
    for a, b in zip(gc, gr):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item())
    updated = {}
    for dev in ("cuda", "cpu"):
        p = _tree_map(lambda t: t.detach().to(dev).clone(), params)
        g, _ = clip_by_global_norm(from_leaves(params, [g.to(dev) for g in gc]), 1.0)
        p, _ = opt.update(p, opt.init(p), g, 0)
        updated[dev] = {k: v.cpu() for k, v in _flat(p).items()}
    for k, b in updated["cpu"].items():
        a = updated["cuda"][k]
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item()), k



@pytest.mark.gpu
def test_profiler_times_bf16_gemms_with_cuda_events():
    """``core.profiler`` on the card: CUDA-event times that grow with the
    batch, and a utilization fit against the H100 peak within (0, 1]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device import GPU_PEAKS
    from repro_torch.core.profiler import fit_utilization, profile_matmul_batches
    batches, dim = (1024, 4096, 16384), 2048
    line = profile_matmul_batches(batches, dim=dim, device="cuda")
    assert line.b > 0 and line(batches[-1]) > line(batches[0])
    util = fit_utilization([2.0 * b * dim * dim for b in batches],
                           [line(b) for b in batches], GPU_PEAKS["H100"]["peak_flops"])
    assert util is not None and 0 < util <= 1


@pytest.mark.gpu
def test_tag_search_traces_on_the_card(capsys):
    """The train launcher's plan on the card: fake CUDA tensors trace, the
    search runs, and one device falls back with the explicit warning."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import train as ttrain
    losses = ttrain.main(["--smoke", "--tag-search", "--steps", "2", "--batch", "2",
                          "--seq", "32"])
    out = capsys.readouterr().out
    assert "TAG plan: speedup=" in out and "on cuda" in out
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.gpu
@pytest.mark.parametrize("schedule,sync,n_devices", [("1f1b", "allreduce", 1),
                                                     ("1f1b", "sfb", 2)])
def test_pipeline_engine_on_card_matches_single_device(schedule, sync, n_devices):
    """The eager pipeline engine on one card, every stage on ``cuda:0``
    (2 stages, or 2 stages of 2 data-parallel shards each with SFB): loss and
    gradients of reduced qwen2-1.5b in f32 against the single-device
    gradient on the card, 1e-4 (the tolerance of tests/test_exec.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_reduced
    from repro_torch.exec import PipelineRunner, StagePlan, StageSpec, split_model
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim.adam import from_leaves, leaves
    cfg = get_reduced("qwen2-1.5b").replace(dtype="float32")
    dev = torch.device("cuda", 0)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 16)), device=dev)
             for k in ("tokens", "labels")}
    ps = [t.clone().requires_grad_(True) for t in leaves(params)]
    loss, _ = loss_fn(cfg, from_leaves(params, ps), batch, remat=False)
    ref = from_leaves(params, list(torch.autograd.grad(loss, ps)))
    plan = StagePlan(
        stages=[StageSpec(i, i, [i], flops=1e9, param_bytes=0, grad_bytes=0, out_bytes=1e5,
                          sync=sync, n_devices=n_devices, gpu_type="H100") for i in range(2)],
        placement=(0, 1), n_micro=4 if n_devices == 1 else 2)
    sp, fns, keys, tied = split_model(cfg, params, 2)
    runner = PipelineRunner(fns, plan, [[dev] * n_devices] * 2, schedule=schedule,
                            mb_keys=keys, tied_ref=tied)
    grads, stats = runner.step(runner.place_params(sp), batch, record=True)
    assert abs(stats.loss - float(loss)) < 1e-4
    hi = cfg.num_periods // 2
    pairs = [(grads[0]["embed"], ref["embed"]), (grads[1]["final_norm"], ref["final_norm"])]
    pairs += list(zip(leaves(grads[0]["blocks"]), [t[:hi] for t in leaves(ref["blocks"])]))
    pairs += list(zip(leaves(grads[1]["blocks"]), [t[hi:] for t in leaves(ref["blocks"])]))
    for a, b in pairs:
        assert a.device == dev
        assert (a - b).abs().max().item() < 1e-4
    assert stats.peak_stash == 3 and {e[0] for e in stats.events} == {"F", "B"}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-v0.1-52b"])
def test_moe_fwd_on_card_matches_cpu(arch):
    """One MoE layer of the reduced config in 2 groups at capacity factor 0.5
    (assignments drop), in both combines, on the card against the CPU:
    routing equal (experts, ranks, kept slots, slot tables), y 1e-5, aux
    1e-6 (f32, TF32 off; the scatter combine's index_add sums in no fixed
    order on the card), and no host synchronization (run inside a CUDA
    graph capture, which refuses one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh, steps
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import axis_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for combine in ("gather", "scatter"):
        cfg = get_reduced(arch).replace(dtype="float32", capacity_factor=0.5,
                                        moe_combine=combine)
        D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        w = {"router": rng.standard_normal((D, E)) * 2 / np.sqrt(D),
             "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
             "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
             "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
        x = rng.standard_normal((4, 32, D))
        out = {}
        for d in (torch.device("cpu"), dev):
            p = {k: torch.as_tensor(v, dtype=torch.float32, device=d) for k, v in w.items()}
            xd = torch.as_tensor(x, dtype=torch.float32, device=d)
            rules = steps.baseline_rules(mesh.make_host_mesh([d] * 2))
            with axis_rules(rules):
                if d.type == "cuda":
                    moe.moe_layer(cfg, p, xd)                       # warm-up
                    torch.cuda.synchronize()
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph):
                        y, r = moe.moe_layer(cfg, p, xd)
                    graph.replay()
                    torch.cuda.synchronize()
                else:
                    y, r = moe.moe_layer(cfg, p, xd)
            out[d.type] = (y.cpu(), float(moe.aux_loss(r.density, r.mean_probs)),
                           {k: getattr(r, k).cpu() for k in ("e_idx", "pos", "keep", "idx",
                                                              "filled")})
        (yc, ac, rc), (yg, ag, rg) = out["cpu"], out["cuda"]
        assert not bool(rc["keep"].all())
        for k in rc:
            assert torch.equal(rg[k], rc[k]), (combine, k)
        assert (yg - yc).abs().max().item() <= 1e-5, combine
        assert abs(ag - ac) <= 1e-6, combine


@pytest.mark.gpu
def test_jamba_prefill_through_both_kernels_matches_plain():
    """Reduced jamba's prefill with ``attn_impl="pallas"`` on the card (the
    flash kernel on its attention layer, the SSD kernel on its Mamba layer,
    state 16) against the plain route on the card, f32, TF32 off, 2e-3 (the
    kernel-route tolerance of tests/test_extensions.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import init_params, prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_reduced("jamba-v0.1-52b").replace(dtype="float32", num_layers=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 256)),
                             device=dev)
    before = (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches)
    kern = prefill_step(cfg.replace(attn_impl="pallas"), params, {"tokens": tokens})
    torch.cuda.synchronize()
    launched = (fa_mod.flash_attention.launches - before[0],
                ssd_mod.ssd_scan.launches - before[1])
    plain = prefill_step(cfg, params, {"tokens": tokens})
    assert launched == (cfg.pattern.count("A") * cfg.num_periods,
                        cfg.pattern.count("M") * cfg.num_periods)
    assert bool(torch.isfinite(kern).all())
    assert (kern - plain).abs().max().item() <= 2e-3


# (name, schedule, sync, devices a stage, n_micro, chunks a stage, unroll)
SCAN_CASES = [
    ("1f1b", "1f1b", "allreduce", 1, 4, 1, 1),
    ("zb-unroll3", "zb", "allreduce", 1, 4, 1, 3),
    ("interleaved-unroll4", "interleaved", "allreduce", 1, 4, 2, 4),
    ("1f1b-sfb-dp2", "1f1b", "sfb", 2, 2, 1, 1),
    ("zb-ps-dp2-unroll2", "zb", "ps", 2, 2, 1, 2),
]


# reduced configs as tests/test_torch_pipeline.py runs them: jamba at 4
# layers (a Mamba layer and an attention layer with an MoE FFN a stage),
# the MoE models at capacity factor 0.5, where assignments drop
SCAN_ARCH_KW = {"mamba2-130m": {"ssm_chunk": 32}, "olmoe-1b-7b": {"capacity_factor": 0.5},
                "jamba-v0.1-52b": {"ssm_chunk": 32, "num_layers": 4, "capacity_factor": 0.5}}
SCAN_SEQ = {"mamba2-130m": 64, "jamba-v0.1-52b": 32}


def _scan_setup(arch, sync, n, n_micro, V, devices):
    from repro_torch.configs import get_reduced
    from repro_torch.exec import StagePlan, StageSpec, split_model
    from repro_torch.models.model import init_params
    cfg = get_reduced(arch).replace(dtype="float32", **SCAN_ARCH_KW.get(arch, {}))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = StagePlan(
        stages=[StageSpec(i, i, [i], flops=1e9, param_bytes=0, grad_bytes=0, out_bytes=1e5,
                          sync=sync, n_devices=n, gpu_type="H100") for i in range(2)],
        placement=(0, 1), n_micro=n_micro)
    out = {}
    for dev in devices:
        p = _tree_map(lambda t: t.detach().to(dev).clone(), params)
        splits = plan.layer_splits(cfg.num_periods, n_chunks=V)
        out[dev] = split_model(cfg, p, 2 * V, splits=splits)
    return cfg, plan, out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m", "olmoe-1b-7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("case", [c[0] for c in SCAN_CASES])
def test_scan_engine_captured_matches_uncaptured(case, arch):
    """The compiled engine on the card, each loop a CUDA graph captured at
    the first step and replayed after, against the same engine uncaptured on
    the CPU and the eager engine on the card: 3 steps, each on a new batch,
    AdamW updating the card's parameters in place between them (so the
    replays read new inputs and new parameters). Loss 1e-4 relative and
    every gradient leaf 1e-4 x max(1, max |g|), TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.exec import CompiledPipelineRunner, PipelineRunner
    from repro_torch.optim.adam import AdamW, leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    _, sched, sync, n, n_micro, V, unroll = next(c for c in SCAN_CASES if c[0] == case)
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    cfg, plan, split = _scan_setup(arch, sync, n, n_micro, V, (dev, cpu))
    runners = {}
    for name, d, cls, kw in (("scan", dev, CompiledPipelineRunner, {"unroll": unroll}),
                             ("eager", dev, PipelineRunner, {}),
                             ("cpu", cpu, CompiledPipelineRunner, {"unroll": unroll})):
        sp, fns, keys, tied = split[d]
        r = cls(fns, plan, [[d] * n] * 2, schedule=sched, n_micro=n_micro, n_chunks=V,
                mb_keys=keys, tied_ref=tied, **kw)
        runners[name] = (r, r.place_params(sp))
    opt = AdamW(lr=1e-3)
    scan, params = runners["scan"]
    state = [opt.init(p) for p in params]
    rng = np.random.default_rng(1)
    seq = SCAN_SEQ.get(arch, 16)
    for step in range(3):
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, seq)))
                 for k in ("tokens", "labels")}
        g_scan, s_scan = scan.step(params, {k: v.to(dev) for k, v in batch.items()})
        assert s_scan.peak_stash == 2 * V * n_micro
        others = [runners["eager"][0].step(params, {k: v.to(dev) for k, v in batch.items()})]
        if step == 0:
            others.append(runners["cpu"][0].step(runners["cpu"][1], batch))
        for g_ref, s_ref in others:
            assert abs(s_scan.loss - s_ref.loss) <= 1e-4 * abs(s_ref.loss), (step, case)
            for a, b in zip((x for g in g_scan for x in leaves(g)),
                            (x for g in g_ref for x in leaves(g)), strict=True):
                assert a.device == dev and bool(torch.isfinite(a).all())
                if b.numel():
                    err = (a - b.to(dev)).abs().max().item()
                    assert err <= 1e-4 * max(1.0, b.abs().max().item()), (step, case, err)
        for p, s, g in zip(params, state, g_scan, strict=True):
            opt.update(p, s, g, step)           # in place: the graphs read p
    torch.cuda.synchronize()


def _gnn_case():
    """A reduced qwen2-1.5b graph traced on meta tensors and grouped, the
    testbed, and its featurized empty strategy."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import tag as tag_mod
    from repro_torch.core.device import testbed
    from repro_torch.core.features import featurize
    from repro_torch.core.strategy import Strategy
    from repro_torch.models.model import abstract_params, input_specs, loss_fn
    cfg = get_reduced("qwen2-1.5b")
    gg = tag_mod.build_grouped(lambda p, b: loss_fn(cfg, p, b, remat=False)[0],
                               abstract_params(cfg),
                               input_specs(cfg, InputShape("plan", 32, 4, "train")), "qwen", 10)
    topo = testbed()
    return gg, topo, featurize(gg, topo, Strategy.empty(gg.n), None, 0)


@pytest.mark.gpu
def test_gnn_priors_and_gradient_on_card_match_cpu():
    """The GNN on the card against the CPU from the same parameters: priors
    at 1e-5; ``record_loss_core``'s gradient, f32 on the card, within 2e-5 of
    a leaf's scale of the f64 gradient on the CPU (f32 rounding, as in
    tests/test_torch_gnn.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core import hetgnn, trainer
    from repro_torch.core.mcts import MCTS
    from repro_torch.core.strategy import candidate_actions
    gg, topo, het = _gnn_case()
    state = trainer.init_trainer(seed=0, device="cpu")
    cuda = hetgnn.params_from_numpy(state.params, "cuda")
    actions = candidate_actions(topo, has_grad=True)
    for gid in (0, gg.n - 1):
        on_card = hetgnn.policy_probs(state.cfg, cuda, het, gid, actions)
        assert on_card.device.type == "cuda"
        torch.testing.assert_close(on_card.cpu(), hetgnn.policy_probs(
            state.cfg, state.params, het, gid, actions), rtol=0, atol=1e-5)
    records = MCTS(gg, topo, seed=0, record_threshold=4).search(8).visit_records
    assert records
    for het_r, gid, acts, pi in records[:2]:
        P, O, mask = hetgnn.actions_to_arrays(acts, het_r.dev_x.shape[0])
        pi_pad = np.zeros((P.shape[0],), np.float32)
        pi_pad[:len(pi)] = pi
        grads = {}
        for name, params in (("card", cuda), ("f64", {k: v.double() for k, v in
                                                       state.params.items()})):
            leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
            loss = hetgnn.record_loss_core(state.cfg, leaves, hetgnn._het_arrays(het_r), gid,
                                           P, O, mask, pi_pad)
            grads[name] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for k, ref in grads["f64"].items():
            err = float((grads["card"][k].cpu().double() - ref).abs().max())
            assert err <= 2e-5 * max(1.0, float(ref.abs().max())), k


@pytest.mark.gpu
def test_cached_policy_mcts_stays_on_the_card():
    """A ``CachedPolicy``-guided MCTS on the card: one encoder run a search,
    the embeddings and candidate slices stay on the card, and once they are
    there (after a first search) the only synchronizing copies are the
    probabilities back to the host, one an expansion."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings
    from repro_torch.core import trainer
    from repro_torch.core.mcts import MCTS
    gg, topo, _ = _gnn_case()
    state = trainer.init_trainer(seed=0)
    pol = trainer.make_policy(state.cfg, state.params)
    assert all(v.device.type == "cuda" for v in pol.params.values())
    first = MCTS(gg, topo, policy=pol, seed=0).search(10)
    assert pol.misses == 1 and pol.hits >= 5 and first.best_reward >= 1.0 - 1e-9
    assert all(e.device.type == "cuda" for e in next(iter(pol._cache.values())))
    assert all(t.device.type == "cuda" for sl in pol._slices.values() for t in sl)
    calls = pol.hits + pol.misses
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            MCTS(gg, topo, policy=pol, seed=1).search(20)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
    expansions = pol.hits + pol.misses - calls
    assert pol.misses == 1 and expansions >= 5
    assert len(syncs) == expansions, [str(w.message) for w in syncs[:3]]


@pytest.mark.gpu
def test_serve_plan_topo_observe_smoke_on_card(tmp_path, capsys):
    """``serve --smoke --plan-topo testbed --observe`` on the card: a cold
    plan, the observation fed back, and a cache hit the second time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--plan-topo", "testbed", "--observe",
            "--batch", "2", "--prompt-len", "8", "--gen", "4", "--plan-iters", "4",
            "--plan-cache", str(tmp_path / "plans"), "--telemetry-dir", str(tmp_path / "t")]
    tserve.main(argv)
    first = capsys.readouterr().out
    tserve.main(argv)
    second = capsys.readouterr().out
    assert "plan[testbed] source=cold iters=4" in first and "on cuda" in first
    assert "observe[testbed] step=" in first and "kind=" in first
    assert "plan[testbed] source=hit iters=0" in second


@pytest.mark.gpu
def test_profiled_train_step_runs_once_on_card(tmp_path, capsys):
    """``train --xla-profile`` on the card: step 1 runs once under
    torch.profiler, whose trace holds CUDA kernels, and the losses equal an
    unprofiled run's from the same seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    from repro_torch.launch import train as ttrain
    from repro_torch.launch import steps as tsteps
    calls = []
    make = tsteps.make_train_step

    def counting(*a, **kw):
        step = make(*a, **kw)

        def run(*args, **kwargs):
            calls.append(1)
            return step(*args, **kwargs)
        return run

    base = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "32", "--seed", "3"]
    ref = ttrain.main(base)
    tsteps.make_train_step = counting
    try:
        got = ttrain.main([*base, "--xla-profile", "--trace-dir", str(tmp_path)])
    finally:
        tsteps.make_train_step = make
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("xla-profile: "))
    meta = json.loads(line[len("xla-profile: "):line.index(" (")])
    assert calls == [1, 1, 1] and meta["profiler"] == "ok"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    with open(meta["trace_file"]) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
    assert "kernel" in cats


@pytest.mark.gpu
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("sync", ["allreduce", "ps", "sfb"])
def test_dp_mlp_loss_on_card_matches_one_device(sync, n_dev):
    """``dp_mlp_loss`` over ``[cuda:0] * n_dev``, f32, TF32 off: each leaf's
    gradient within 1e-4 of its max of the same MLP on one device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sfb_dense import dp_mlp_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    widths = (256, 512, 64)
    gen = torch.Generator(device=dev).manual_seed(0)
    ps = [(torch.randn(a, b, device=dev, generator=gen) * 0.05).requires_grad_()
          for a, b in zip(widths[:-1], widths[1:])]
    x = torch.randn(16, widths[0], device=dev, generator=gen)
    y = torch.randn(16, widths[-1], device=dev, generator=gen)
    loss = dp_mlp_loss(make_mesh((n_dev,), ("data",), [dev] * n_dev), "data", sync, widths)
    got = torch.autograd.grad(loss(ps, x, y), ps)
    h = x
    for i, w in enumerate(ps):
        h = h @ w if i == len(ps) - 1 else torch.relu(h @ w)
    one = torch.autograd.grad(((h - y) ** 2).mean(), ps)
    for g, r in zip(got, one):
        assert float((g - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))


@pytest.mark.gpu
def test_scan_engine_capture_refuses_a_host_copy():
    """A stage that copies from the host inside a loop cannot be captured:
    the step raises, and nothing falls back to the uncaptured loop. (Last in
    this file: the failed capture is left to the CUDA context.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.exec import CompiledPipelineRunner
    dev = torch.device("cuda", 0)
    cfg, plan, split = _scan_setup("qwen2-1.5b", "allreduce", 1, 4, 1, (dev,))
    sp, fns, keys, tied = split[dev]
    last = fns[1]

    def host_copy(p, carry, mb):
        loss, mets = last(p, carry, mb)
        return loss * torch.tensor(1.0, device=loss.device), mets

    runner = CompiledPipelineRunner([fns[0], host_copy], plan, [[dev], [dev]],
                                    mb_keys=keys, tied_ref=tied)
    batch = {k: torch.zeros((8, 16), dtype=torch.long, device=dev) for k in ("tokens", "labels")}
    with pytest.raises(RuntimeError):
        runner.step(runner.place_params(sp), batch)
