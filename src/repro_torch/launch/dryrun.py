"""Dry run: trace a step of every (arch x input shape) on the production
meshes of H100 GPUs, on ``meta`` tensors (the counterpart of ``repro``'s
``ShapeDtypeStruct`` stand-ins: nothing is allocated), and extract the
roofline terms of one device from the run (``core/step_analysis.py``).

    python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json

``lower_one`` returns ``repro``'s keys. Where a key's XLA meaning has no
counterpart it keeps its name, with this meaning:

* ``lower_s``: seconds to trace the step once on ``meta`` tensors;
* ``compile_s``: 0.0, nothing is compiled;
* ``hlo_flops`` and ``hlo_bytes``: position 0's matmul FLOPs and aten
  operand and result bytes (``StepStats.flops``, ``bytes_accessed``);
* ``xla_cost_analysis``: ``FlopCounterMode``'s raw totals over every
  traced position, and the bytes of every traced op;
* ``while_trips``: empty, no while loops;
* ``memory``: ``argument_bytes`` and ``output_bytes`` of one device from
  the shardings, with the train step's moments in the parameters' dtype
  and token ids in int32, as ``repro`` lowers them; ``temp_bytes`` the
  peak of position 0's live ``meta`` bytes over the step, ``code_bytes``
  0.

A mesh of at most ``FULL_TRACE_POSITIONS`` positions is traced whole. A
larger one, such as the production meshes' 256 and 512, is traced on the
same grid of positions with one row of the batch axes: the rows' splits
are equal, so every row's positions have the same shapes and run the same
program, and the collectives of the batch axes (the gradients' sum over
the rows) are recorded at the full mesh's row count. A parameter split
over the rows is laid out for the full mesh (``Mesh.stands_for``): the
traced row holds its slice, gathers it with stand-ins for the other rows'
slices, and its all-gathers and reduce-scatters are recorded with the
bytes and participants of the full row group. Position 0's counts are
those of the whole mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, config_for_shape
from repro_torch.core.step_analysis import analyze_step
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as model_mod
from repro_torch.optim.adam import AdamW, leaves
from repro_torch.parallel import tensor as tp_mod
from repro_torch.parallel.sharding import axis_rules, rules_fingerprint

FULL_TRACE_POSITIONS = 16


def roofline_terms(flops, hbm_bytes, coll_bytes, n_chips,
                   links_per_chip=mesh_mod.HW["links_per_chip"]):
    hw = mesh_mod.HW
    return {
        # the counts are a device's
        "compute_s": flops / hw["peak_flops_bf16"],
        "memory_s": hbm_bytes / hw["hbm_bw"],
        "collective_s": coll_bytes / (hw["ici_bw"] * links_per_chip),
    }


def _local_bytes(tensors, shardings, mesh) -> int:
    """One device's bytes of ``tensors`` laid out by ``shardings``."""
    total = 0
    for t, s in zip(leaves(tensors), leaves(shardings), strict=True):
        split = 1
        for e in s.spec:
            for a in (e if isinstance(e, tuple) else (e,)) if e is not None else ():
                split *= mesh.shape[a]
        total += t.numel() * t.element_size() // split
    return total


def _traced_mesh(mesh):
    """``mesh`` itself, or the grid of one row of its batch axes (module
    docstring) as the stand-in for a larger mesh."""
    if mesh.size <= FULL_TRACE_POSITIONS:
        return mesh, 1
    rows = [a for a in mesh.axis_names if a in ("pod", "data")]
    n = int(np.prod([mesh.shape[a] for a in rows]))
    shape = tuple(1 if a in rows else mesh.shape[a] for a in mesh.axis_names)
    traced = mesh_mod.make_mesh(shape, mesh.axis_names, [mesh.devices.flat[0]] * (mesh.size // n))
    traced.stands_for = mesh
    return traced, n


def _args(cfg, shape, rules, opt):
    """The step's arguments on ``meta`` tensors, laid out as the step takes
    them."""
    lay = tp_mod.layout(cfg, rules)
    aparams = model_mod.abstract_params(cfg)
    sharded = lay is not None and lay.sharded

    def lay_out(tree):
        return tp_mod.shard_params(cfg, tree, rules) if sharded else tree
    specs = model_mod.input_specs(cfg, shape)
    if shape.kind == "train":
        state = opt.init(aparams)
        state = {k: lay_out(v) for k, v in state.items()}
        return (lay_out(aparams), state, 0, specs)
    if shape.kind == "prefill":
        return (lay_out(aparams), specs)
    n = 1 if lay is None else lay.n
    B = shape.global_batch
    with axis_rules(rules):
        rows = B // n if lay is not None and steps_mod._rows_split(rules, specs["tokens"]) else B
    if sharded:
        cache = tp_mod.init_cache_shards(lay, rows, shape.seq_len)
    elif lay is not None:
        cache = [model_mod.init_cache(cfg, rows, shape.seq_len, d) for d in lay.grid[:, 0]]
    else:
        cache = model_mod.cache_specs(cfg, B, shape.seq_len)
    return (lay_out(aparams), cache, specs["tokens"], shape.seq_len - 1)


def lower_one(arch: str, shape_name: str, mesh, *, overrides=None,
              grad_sync=None, options=None, cfg_overrides=None,
              profile: bool = False, with_stats: bool = False):
    """Trace one (arch, shape) step on ``mesh`` (a mesh of ``meta``
    devices) and return ``repro``'s stats dict (module docstring); with
    ``with_stats``, (dict, ``StepStats``)."""
    shape = SHAPES[shape_name]
    cfg = config_for_shape(arch, shape_name)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    rules = steps_mod.baseline_rules(mesh, overrides=overrides, grad_sync=grad_sync)
    opts = options or steps_mod.StepOptions()
    opt = AdamW()

    traced, n_rows = _traced_mesh(mesh)
    trules = dataclasses.replace(rules, mesh=traced)
    t0 = time.time()
    if shape.kind == "train":
        step, ps, opt_sh, bs = steps_mod.jit_train_step(cfg, opt, trules, shape, opts)
    elif shape.kind == "prefill":
        step, ps, _, bs = steps_mod.jit_prefill_step(cfg, trules, shape)
    else:
        step, ps, cs, bs = steps_mod.jit_serve_step(cfg, trules, shape)
    B = shape.global_batch
    # the traced row's share of the batch: its rows where the row count
    # divides the batch, else all of them (replicated over the rows)
    tshape = dataclasses.replace(shape, global_batch=B // n_rows if B % n_rows == 0 else B)
    args = _args(cfg, tshape, trules, opt)
    with tp_mod.stand_in_rows(n_rows):
        stats = analyze_step(step, *args, mesh=traced)
    t_lower = time.time() - t0
    if profile:
        print(stats.summary(18), flush=True)

    # a device's arguments and outputs, from the full mesh's shardings
    aparams = model_mod.abstract_params(cfg)
    p_bytes = _local_bytes(aparams, steps_mod.param_shardings(cfg, rules), mesh)
    # token ids as repro lowers them, int32 (the port's are int64)
    specs = {k: v.to(torch.int32) if v.dtype == torch.long else v
             for k, v in model_mod.input_specs(cfg, shape).items()}
    b_bytes = _local_bytes(specs, steps_mod.batch_shardings(cfg, shape, rules), mesh)
    if shape.kind == "train":
        m_bytes = 2 * p_bytes   # the moments, as repro lowers them: the parameters' dtype
        arg_bytes, out_bytes = p_bytes + m_bytes + b_bytes + 4, p_bytes + m_bytes + 16
    elif shape.kind == "prefill":
        arg_bytes = p_bytes + b_bytes
        out_bytes = b_bytes // specs["tokens"].shape[1] * cfg.vocab_size * \
            aparams["embed"].element_size() // specs["tokens"].element_size()
    else:
        c_bytes = _local_bytes(model_mod.cache_specs(cfg, shape.global_batch, shape.seq_len),
                               steps_mod.cache_shardings(cfg, shape, rules), mesh)
        arg_bytes, out_bytes = p_bytes + c_bytes + b_bytes + 4, c_bytes + b_bytes

    n_chips = mesh.devices.size
    terms = roofline_terms(stats.flops, stats.bytes_accessed, stats.collective_wire_bytes,
                           n_chips)
    dominant = max(terms, key=terms.get)
    res = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "n_chips": int(n_chips),
        "kind": shape.kind,
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
        "hlo_flops": stats.flops,
        "hlo_bytes": stats.bytes_accessed,
        "xla_cost_analysis": {"flops": stats.raw_flops, "bytes": stats.raw_bytes},
        "collectives": {"bytes": dict(stats.collective_bytes),
                        "counts": dict(stats.collective_counts),
                        "total_bytes": stats.collective_wire_bytes},
        "while_trips": stats.while_trips,
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(stats.temp_bytes),
            "code_bytes": 0,
        },
        "roofline": terms,
        "dominant": dominant,
        "params": config_for_shape(arch, shape_name).param_count(),
        "active_params": config_for_shape(arch, shape_name).param_count(active_only=True),
    }
    return (res, stats) if with_stats else res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--loss-chunk", type=int, default=0)
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--profile", action="store_true",
                    help="print per-op byte/flop attribution")
    ap.add_argument("--telemetry-dir", default="",
                    help="append each combo's roofline-estimated step "
                         "record to this measurement log")
    ap.add_argument("--override", action="append", default=[],
                    help="logical=mesh_axis rule override, e.g. embed=data")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = None if v in ("", "none", "None") else (
            tuple(v.split("+")) if "+" in v else v)

    if args.both_meshes:
        meshes = [mesh_mod.make_production_mesh(multi_pod=False),
                  mesh_mod.make_production_mesh(multi_pod=True)]
    else:
        meshes = [mesh_mod.make_production_mesh(multi_pod=args.multi_pod)]

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        combos = [(args.arch, args.shape)]

    opts = steps_mod.StepOptions(loss_chunk=args.loss_chunk, remat_policy=args.remat_policy)
    cfg_overrides = {}
    if args.attn_chunk:
        cfg_overrides["attn_chunk"] = args.attn_chunk
    if args.capacity_factor:
        cfg_overrides["capacity_factor"] = args.capacity_factor
    telemetry = None
    if args.telemetry_dir:
        from repro_torch.runtime.telemetry import MeasurementStore, StepRecord
        telemetry = MeasurementStore(args.telemetry_dir)

    results, seen = [], set()
    for mesh in meshes:
        for arch, shape in combos:
            tag = f"{arch} x {shape} @ {mesh.devices.shape}"
            # a combination is keyed by the rules it lowers under
            with axis_rules(steps_mod.baseline_rules(mesh, overrides=overrides or None)):
                key = (arch, shape, rules_fingerprint())
            if key in seen:
                continue
            seen.add(key)
            try:
                r = lower_one(arch, shape, mesh, overrides=overrides or None, options=opts,
                              cfg_overrides=cfg_overrides or None, profile=args.profile)
                r["ok"] = True
                if telemetry is not None:
                    # the roofline's step estimate (the dominant term) and
                    # the trace's cost for each (arch, shape, mesh); no
                    # per-op samples, so it does not feed fit_profile
                    telemetry.append(StepRecord(
                        wall_time=max(r["roofline"].values()),
                        meta={"arch": arch, "shape": shape,
                              "mesh": r["mesh"], "launcher": "dryrun",
                              "dominant": r["dominant"],
                              "compile_s": r["compile_s"],
                              "lower_s": r["lower_s"]}))
                terms = r["roofline"]
                print(f"OK  {tag}: lower={r['lower_s']}s "
                      f"flops={r['hlo_flops']:.3e} bytes={r['hlo_bytes']:.3e} "
                      f"coll={r['collectives']['total_bytes']:.3e} "
                      f"dominant={r['dominant']} "
                      f"terms=({terms['compute_s']:.4f},"
                      f"{terms['memory_s']:.4f},{terms['collective_s']:.4f})s",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — a combination's failure is reported
                r = {"arch": arch, "shape": shape,
                     "mesh": "x".join(str(s) for s in mesh.devices.shape),
                     "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"FAIL {tag}: {r['error']}", flush=True)
            results.append(r)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} combinations traced")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
